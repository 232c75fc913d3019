#!/usr/bin/env python3
"""Device time of the served device programs, from ``jax.profiler`` traces.

Run on a machine with one GPU, from the root of a checkout:

    python tools/device_trace.py [--out chiprun_out/device_trace.json] [--cli-mb 1024]

What it measures (everything on the card named by nvidia-smi):

* per-call device time of ``basic_encode`` and ``flat_encode`` at one 16 MiB
  batch (``runner.DEVICE_BATCH_BYTES``) and of ``multipass_encode`` on a
  16 MiB chunk with a hierarchical table, each the union of the device
  events of K back-to-back calls over K, with its share of the HBM roofline
  (3 bytes moved per input byte at the published 3.35 TB/s);
* a large plain copy, for what the card reaches on a pure stream;
* the device-busy share of three traced windows: the 1 GiB basic and flat-
  BPE CLI runs (``BLT_PROFILE``, which wraps the compute-and-drain loop)
  and the 64 MiB hierarchical ``ByteTokenizer.tokenize_file`` on the jax
  engine.

The CLI runs go first, each its own process, while this process stays off
the card; the in-process windows run in one child. Traces go to a work
directory inside the checkout and are removed once reduced; the summary is
written to ``--out`` and a short JSON line is printed last.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MiB = 1 << 20
TRACES = os.path.join(ROOT, ".smoke_work", "device_trace")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
K = 10  # calls per kernel window


def union_ns(intervals) -> float:
    """Total length covered by (start, end) intervals (overlaps once)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_lines(plane):
    """The lines of a device plane that hold its kernels and copies: the
    per-stream lines when the trace has them (derived lines such as "XLA
    Modules" span whole programs, gaps included), else every line."""
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.lower().startswith("stream")]
    return streams or lines


def is_copy(name: str) -> bool:
    return "memcpy" in name.lower() or "memset" in name.lower()


def reduce_trace(trace_dir: str) -> dict:
    """Device busy time, window and top kernels of one trace directory."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    busy, compute, host = [], [], []
    kernels: dict = {}
    planes = []
    for plane in pd.planes:
        lines = list(plane.lines)
        planes.append({"plane": plane.name,
                       "lines": [ln.name for ln in lines][:12]})
        if plane.name.startswith("/device:GPU"):
            for line in device_lines(plane):
                for ev in line.events:
                    iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                    busy.append(iv)
                    if not is_copy(ev.name):
                        compute.append(iv)
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.duration_ns
        elif plane.name.startswith("/host:CPU"):
            for line in lines:
                host.extend((ev.start_ns, ev.start_ns + ev.duration_ns)
                            for ev in line.events)
    window = (max(e for _, e in host) - min(s for s, _ in host)) if host else 0.0
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        "trace": paths[-1],
        "device_busy_ns": union_ns(busy),
        "device_compute_ns": union_ns(compute),
        "window_ns": window,
        "busy_share": union_ns(busy) / window if window else None,
        "top_events_ns": top,
        "planes": planes,
    }


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi ({type(e).__name__})"


def kernel_windows(seed: int) -> dict:
    """Child: the in-process windows (this process holds the card)."""
    import jax
    import jax.numpy as jnp

    import blt_tpu as blt
    from blt_tpu.merges import MergeTable
    from blt_tpu.ops import bpe_jax
    from blt_tpu.utils import synth
    from blt_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"device_trace needs a GPU, JAX has {dev}")
    n = 16 * MiB
    sample = synth.zipf_text(seed, 4 * MiB)
    flat = synth.top_pair_merges(sample)
    hier = synth.hierarchical_merges(sample[:MiB], flat)
    data = jnp.asarray(synth.zipf_text(seed + 1, n))
    dense = bpe_jax.dense_table_device(MergeTable.build(flat))
    keys, vals = bpe_jax.sparse_table_device(MergeTable.build(hier))
    big = jnp.zeros(256 * MiB, jnp.uint8)
    copy = jax.jit(lambda x: x ^ 1)
    calls = {
        "basic_encode": (lambda: bpe_jax.basic_encode(data), 3 * n),
        "flat_encode": (lambda: bpe_jax.flat_encode(
            data, jnp.int32(n), dense, jnp.asarray(False), jnp.int32(-1)),
            3 * n),
        "multipass_encode": (lambda: bpe_jax.multipass_encode(
            data, jnp.int32(n), keys, vals), 3 * n),
        "copy_256MiB": (lambda: copy(big), 2 * big.size),
    }
    res = {}
    for name, (fn, nbytes) in calls.items():
        jax.block_until_ready(fn())  # compile outside the window
        t0 = time.perf_counter()
        for _ in range(K):
            r = fn()
        jax.block_until_ready(r)
        wall = (time.perf_counter() - t0) / K
        tdir = os.path.join(TRACES, name)
        with jax.profiler.trace(tdir):
            for _ in range(K):
                r = fn()
            jax.block_until_ready(r)
        red = reduce_trace(tdir)
        per_call = red["device_busy_ns"] / K * 1e-9
        res[name] = {
            "device_s_per_call": per_call,
            "wall_s_per_call": wall,
            "bytes_moved": nbytes,
            "achieved_bytes_per_s": nbytes / per_call if per_call else None,
            "hbm_roofline_share": (nbytes / HBM_BYTES_PER_S) / per_call
            if per_call else None,
            "top_events_ns": red["top_events_ns"][:4],
        }
        print(json.dumps({name: res[name]}), flush=True)
    res["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    res["planes_example"] = red["planes"]

    # the hierarchical API window (phase 5's path: per-chunk multi-pass)
    inp = os.path.join(TRACES, "api_in.bin")
    with open(inp, "wb") as f:
        f.write(synth.zipf_text(seed + 4, 64 * MiB).tobytes())
    tok = blt.ByteTokenizer(merges=hier, engine="jax")
    tok.tokenize_file(inp, inp + ".warm")  # compile outside the window
    tdir = os.path.join(TRACES, "api_multipass")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        tok.tokenize_file(inp, inp + ".out")
    wall = time.perf_counter() - t0
    red = reduce_trace(tdir)
    res["api_multipass_64MiB"] = {k: red[k] for k in (
        "device_busy_ns", "device_compute_ns", "window_ns", "busy_share",
        "top_events_ns")}
    res["api_multipass_64MiB"]["wall_s"] = wall
    for p in (inp, inp + ".warm", inp + ".out"):
        os.unlink(p)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "device_trace.json"))
    ap.add_argument("--cli-mb", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(TRACES, exist_ok=True)
    if args.kernels_only:
        print("KERNELS " + json.dumps(kernel_windows(args.seed)))
        return 0
    try:
        return run_all(args)
    finally:
        shutil.rmtree(TRACES, ignore_errors=True)


def run_all(args) -> int:
    from blt_tpu.utils import synth

    name = card()
    summary = {"card": name, "cli": {}}
    env = dict(os.environ, PYTHONPATH=ROOT)
    work = os.path.join(TRACES, "work")
    os.makedirs(work, exist_ok=True)
    inp = os.path.join(work, "in.bin")
    merges = os.path.join(work, "merges.txt")
    sample = synth.zipf_text(args.seed, 4 * MiB)
    with open(merges, "w") as f:
        f.write(synth.merges_file_text(synth.top_pair_merges(sample)))
    base = synth.zipf_text(args.seed + 2, 64 * MiB)
    with open(inp, "wb") as f:
        for i in range(args.cli_mb // 64):
            f.write(base.tobytes() if i == 0 else
                    bytes(memoryview(base)[i * 7919:]) +
                    bytes(memoryview(base)[: i * 7919]))
    for mode, extra in (("bpe", ["--merges", merges]), ("basic", [])):
        argv = [sys.executable, "-m", "blt_tpu.cli", "-i", inp, "-o",
                os.path.join(work, "out.bin"), *extra]
        t0 = time.perf_counter()
        r = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=900)
        plain = time.perf_counter() - t0
        tdir = os.path.join(TRACES, f"cli_{mode}")
        t0 = time.perf_counter()
        r2 = subprocess.run(argv, env=dict(env, BLT_PROFILE=tdir), cwd=ROOT,
                            capture_output=True, text=True, timeout=900)
        traced = time.perf_counter() - t0
        if r.returncode or r2.returncode:
            print(r.stderr[-2000:], r2.stderr[-2000:], file=sys.stderr)
            return 1
        red = reduce_trace(tdir)
        summary["cli"][mode] = {
            "bytes": os.path.getsize(inp), "wall_s": plain,
            "traced_wall_s": traced,
            **{k: red[k] for k in ("device_busy_ns", "device_compute_ns",
                                   "window_ns", "busy_share",
                                   "top_events_ns")},
        }
        print(f"[{name}] cli {mode}: " + json.dumps(summary["cli"][mode]),
              flush=True)
    for p in glob.glob(os.path.join(work, "*")):
        os.unlink(p)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--kernels-only", "--seed", str(args.seed)],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    print(r.stdout[-6000:].replace("\n{", f"\n[{name}] {{"), flush=True)
    if r.returncode:
        print(r.stderr[-3000:], file=sys.stderr)
        return 1
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("KERNELS ")]
    summary["kernels"] = json.loads(line[-1][len("KERNELS "):])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"card": name, "cli_busy_share": {
        m: summary["cli"][m]["busy_share"] for m in summary["cli"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
