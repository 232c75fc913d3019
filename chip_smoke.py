#!/usr/bin/env python3
"""On-card smoke test: blt's served paths once, end to end, on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --cards 4   # four cards: the sharded paths only

The parent process never imports JAX. It runs each phase as a child
process, one after another, so exactly one process holds the card at a
time; the children share the persistent compile cache
(``blt_tpu.utils.compcache``). Every phase checks that JAX's platform is
``gpu`` and fails on anything else: in-process where the phase itself
holds the card, else from the log of the CLI or server process it starts
(``Device engine ... on N gpu device(s)``), and ``pytest -m gpu`` must
run its tests rather than skip them.

One card:
  1. setup      rebuild the native host library from ``feeder.cpp``; report
                the devices.
  2. kernels    the device programs at real width (one 16 MiB batch) against
                the plain NumPy reference, bit-exact: ``basic_encode``,
                ``flat_encode`` (carry-in and next-byte exercised),
                ``multipass_encode`` (hierarchical table) and
                ``sharded_flat_encode`` on a 1-device mesh.
  3. cli        ``python -m blt_tpu.cli`` file->file on 1 GiB under the AUTO
                engine in basic, BPE and passthrough modes; every output byte
                compared with the same CLI run under ``--engine numpy``.
  4. server     ``blt-serve --engine jax``: 1, 16 and 64 MiB payloads in basic
                and BPE modes against the host engine; clean shutdown.
  5. api        ``ByteTokenizer(merges=<hierarchical>, engine="jax")
                .tokenize_file`` on 64 MiB against ``engine="numpy"``.
  6. gpu_tests  ``pytest -m gpu`` in a child process.

Four cards (``--cards 4``): setup, the 1 GiB basic and BPE CLI legs under
AUTO (which picks the sharded engine; the log must show the batch rows on
all four devices), and the hierarchical table through the sharded engine's
multi-pass path via the API, each compared in full with the host engine.

Inputs are generated from ``--seed``; the flat merges table is the 500 most
frequent byte pairs of the seeded corpus. All device work is integer, so
the tolerance is zero. Every stdout line before the last names the card
(``nvidia-smi --query-gpu=name,power.limit``). The last line is one JSON
object: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}`` when every phase passed, else ``{"ok": false, ...}`` with a non-zero
exit code.

``--rehearse-on-cpu`` runs the same phases on JAX's CPU backend at small
sizes (with explicit ``--engine jax``/``shard`` where AUTO would keep a CPU
host on the host engine). A rehearsal never reports ``"ok": true``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
MiB = 1 << 20
TIME_LIMIT_S = 1150
RESULT_TAG = "RESULT "


# --------------------------------------------------------------------------
# parent
# --------------------------------------------------------------------------


def card_name() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi ({type(e).__name__})"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode != 0 or not lines:
        return f"nvidia-smi failed (rc {r.returncode})"
    return " | ".join(lines)


def child_env(args) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if args.rehearse_on_cpu:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.cards}"
        )
    return env


def kill_group(proc: subprocess.Popen) -> None:
    """Stop a child and everything it started (its own session)."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    proc.wait()


def run_phase_child(name: str, args, card: str, deadline: float):
    """Run one phase in a child; echo its lines tagged with the card."""
    argv = [sys.executable, os.path.abspath(__file__), "--phase", name,
            "--cards", str(args.cards), "--seed", str(args.seed),
            "--cli-mb", str(args.cli_mb), "--batch-mb", str(args.batch_mb),
            "--api-mb", str(args.api_mb), "--serve-mb", args.serve_mb]
    if args.rehearse_on_cpu:
        argv.append("--rehearse-on-cpu")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, text=True, env=child_env(args),
        cwd=ROOT, start_new_session=True,
    )
    result = {}

    def pump():
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line.startswith(RESULT_TAG):
                result.update(json.loads(line[len(RESULT_TAG):]))
            else:
                print(f"[{card}] {name}: {line}", flush=True)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        print(f"[{card}] {name}: TIMEOUT (the whole run must end within "
              f"{TIME_LIMIT_S} s)", flush=True)
    finally:
        kill_group(proc)
    reader.join(timeout=10)
    ok = proc.returncode == 0 and result.get("ok") is True
    print(f"[{card}] {name}: {'PASS' if ok else 'FAIL'} "
          f"(rc {proc.returncode}, {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return ok, result


def parent(args) -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "blt_tpu")):
        print("chip_smoke: no blt_tpu package next to this script; "
              "run it from the root of a checkout", flush=True)
        print(json.dumps({"ok": False, "failed": ["checkout"]}))
        return 2
    card = card_name()
    print(f"[{card}] chip_smoke: cards={args.cards} seed={args.seed} "
          f"cli={args.cli_mb} MiB batch={args.batch_mb} MiB "
          f"api={args.api_mb} MiB serve={args.serve_mb} MiB"
          + (" (CPU rehearsal)" if args.rehearse_on_cpu else ""), flush=True)
    if args.cards == 4:
        phases = ["setup", "cli", "api"]
    else:
        phases = ["setup", "kernels", "cli", "server", "api", "gpu_tests"]
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    deadline = t_start + TIME_LIMIT_S
    failed = []
    device = None
    try:
        for name in phases:
            ok, result = run_phase_child(name, args, card, deadline)
            if name == "setup" and ok:
                device = result.get("device")
            if not ok:
                failed.append(name)
                if name == "setup":
                    break  # nothing below can run without the card
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    ok = not failed and device is not None and not args.rehearse_on_cpu
    print(f"[{card}] card: {card}; phases failed: {failed or 'none'}; "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)
    if ok:
        print(json.dumps({"ok": True, "device": device}))
        return 0
    out = {"ok": False, "failed": failed}
    if args.rehearse_on_cpu:
        out["rehearsal"] = "cpu"
    print(json.dumps(out))
    return 0 if args.rehearse_on_cpu and not failed else 1


# --------------------------------------------------------------------------
# children: one phase each
# --------------------------------------------------------------------------


class PhaseFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def expected_platform(args) -> str:
    return "cpu" if args.rehearse_on_cpu else "gpu"


def check_platform(args) -> dict:
    import jax

    from blt_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    require(dev["platform"] == expected_platform(args),
            f"JAX platform is {dev['platform']!r}, not "
            f"{expected_platform(args)!r}: no card visible")
    require(dev["count"] == args.cards,
            f"{dev['count']} device(s) visible, {args.cards} expected")
    return dev


def compare_bytes(got: bytes, want: bytes) -> str | None:
    """None when equal, else where the first difference is."""
    if got == want:
        return None
    import numpy as np

    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    diff = np.flatnonzero(a != b)
    first = int(diff[0]) if diff.size else n
    return f"{len(got)} vs {len(want)} bytes, first difference at byte {first}"


def compare_files(path_a: str, path_b: str) -> str | None:
    """Every byte of two files; None when identical."""
    sa, sb = os.path.getsize(path_a), os.path.getsize(path_b)
    if sa != sb:
        return f"sizes differ: {sa} vs {sb} bytes"
    block = 64 * MiB
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        pos = 0
        while True:
            a = fa.read(block)
            b = fb.read(block)
            if not a and not b:
                return None
            where = compare_bytes(a, b)
            if where is not None:
                return f"block at byte {pos}: {where}"
            pos += len(a)


def workload(args):
    """(flat merges, hierarchical merges) of the seeded corpus."""
    from blt_tpu.utils import synth

    sample = synth.zipf_text(args.seed, 4 * MiB)
    flat = synth.top_pair_merges(sample)
    hier = synth.hierarchical_merges(sample[: MiB], flat)
    return flat, hier


def write_corpus_file(path: str, seed: int, size: int) -> None:
    """``size`` bytes of seeded text: a 64 MiB block, rotated per copy."""
    import numpy as np

    from blt_tpu.utils import synth

    base = synth.zipf_text(seed, min(size, 64 * MiB))
    with open(path, "wb") as f:
        written, i = 0, 0
        while written < size:
            block = np.roll(base, 7919 * i) if i else base
            n = min(block.size, size - written)
            f.write(block[:n].tobytes())
            written += n
            i += 1


def write_merges_file(path: str, merges) -> None:
    from blt_tpu.utils import synth

    with open(path, "w") as f:
        f.write(synth.merges_file_text(merges))


def phase_setup(args) -> dict:
    from blt_tpu import native
    from blt_tpu.native import build

    path = build.build(verbose=False)
    require(native.available(), f"native library {path} built but not loadable")
    say(f"native host library rebuilt from feeder.cpp: "
        f"{os.path.basename(path)}")
    dev = check_platform(args)
    import jax

    say(f"jax {jax.__version__}: {len(jax.devices())} device(s): "
        f"{[str(d) for d in jax.devices()]}")
    say(f"device_kind {dev['kind']!r}, platform {dev['platform']!r}, "
        f"count {dev['count']}")
    say("every device op is integer (byte widen, table lookup, scans, "
        "scatter): tolerance zero, bit-exact; no float or matrix product, "
        "so TF32 does not arise")
    return {"device": dev}


def phase_kernels(args) -> dict:
    check_platform(args)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from blt_tpu.merges import MergeTable
    from blt_tpu.ops import bpe_jax, bpe_numpy
    from blt_tpu.parallel.mesh import make_mesh, replicated, row_sharding
    from blt_tpu.parallel.mesh import vec_sharding
    from blt_tpu.parallel.sharded import sharded_flat_encode
    from blt_tpu.utils import synth

    n = args.batch_mb * MiB
    flat, hier = workload(args)
    table = MergeTable.build(flat)
    htable = MergeTable.build(hier)
    require(table.flat and not htable.flat, "workload tables malformed")
    corpus = synth.zipf_text(args.seed + 1, 2 * n)
    a, b = corpus[:n].copy(), corpus[n:].copy()
    # force a merge across the batch edge: a[-1], b[0] is a rule and a[-1]
    # starts its run, so flat_encode(a) must report carry_out
    (p, q) = next(iter(flat))
    x = next(x for x in range(256) if (x, p) not in flat)
    a[-2], a[-1], b[0] = x, p, q

    def exact(name: str, got: bytes, want: bytes) -> None:
        where = compare_bytes(got, want)
        require(where is None, f"{name}: mismatch, {where}")
        say(f"{name}: bit-exact ({len(want)} output bytes compared)")

    # basic widen
    out = bpe_jax.basic_encode(jnp.asarray(a))
    exact(f"basic_encode {n} B vs astype('>u2')",
          np.asarray(out).tobytes(), a.astype(">u2").tobytes())

    # flat BPE: two batches chained through carry-in and next-byte
    dense = bpe_jax.dense_table_device(table)
    _, count_a, carry_a, be_a = bpe_jax.flat_encode(
        jnp.asarray(a), jnp.int32(n), dense, jnp.asarray(False),
        jnp.int32(int(b[0])))
    _, count_b, carry_b, be_b = bpe_jax.flat_encode(
        jnp.asarray(b), jnp.int32(n), dense, carry_a, jnp.int32(-1))
    want_a, want_carry = bpe_numpy.bpe_encode_flat_carry(
        a, table, False, int(b[0]))
    want_b, _ = bpe_numpy.bpe_encode_flat_carry(b, table, want_carry, -1)
    require(bool(carry_a) and want_carry, "batch edge did not carry a merge")
    require(not bool(carry_b), "carry_out at EOF")
    got_a = np.asarray(be_a)[: int(count_a)].tobytes()
    got_b = np.asarray(be_b)[: int(count_b)].tobytes()
    exact(f"flat_encode {n} B, next-byte halo, carry_out=True",
          got_a, want_a.astype(">u2").tobytes())
    exact(f"flat_encode {n} B, carry_in=True", got_b,
          want_b.astype(">u2").tobytes())
    whole = bpe_numpy.bpe_encode_flat(np.concatenate([a, b]), table)
    exact("flat_encode chained == one-sequence reference", got_a + got_b,
          whole.astype(">u2").tobytes())
    spec = jax.ShapeDtypeStruct
    compiled = bpe_jax.flat_encode.lower(
        spec((n,), jnp.uint8), spec((), jnp.int32), spec((65536,), jnp.int32),
        spec((), jnp.bool_), spec((), jnp.int32)).compile()
    say(f"flat_encode {n} B memory_analysis: {compiled.memory_analysis()}")

    # general-table multi-pass on a hierarchical table
    keys, vals = bpe_jax.sparse_table_device(htable)
    toks, count = bpe_jax.multipass_encode(
        jnp.asarray(a), jnp.int32(n), keys, vals)
    be = bpe_jax.tokens_to_be_bytes_device(toks)
    want = bpe_numpy.bpe_encode_multipass(a, htable)
    require(int(want.max()) >= 256 + len(flat), "no second-level merge fired")
    exact(f"multipass_encode {n} B, {len(hier)} rules (hierarchical)",
          np.asarray(be)[: int(count)].tobytes(), want.astype(">u2").tobytes())

    # the multi-device step on a 1-device mesh
    mesh = make_mesh(jax.devices()[:1])
    tokens, counts, carry = sharded_flat_encode(
        jax.device_put(a[None, :], row_sharding(mesh)),
        jax.device_put(np.array([n], np.int32), vec_sharding(mesh)),
        jax.device_put(table.dense, replicated(mesh)),
        False, int(b[0]))
    require(bool(carry) == want_carry, "sharded carry_out differs")
    exact(f"sharded_flat_encode {n} B on a 1-device mesh",
          np.asarray(tokens)[0, : int(counts[0])].astype(">u2").tobytes(),
          want_a.astype(">u2").tobytes())
    return {}


def run_cli(args, argv, env) -> tuple[float, str]:
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "blt_tpu.cli", *argv], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    require(r.returncode == 0,
            f"blt {' '.join(argv)} failed (rc {r.returncode}): "
            f"{r.stderr[-2000:]}")
    return wall, r.stderr


def phase_cli(args) -> dict:
    size = args.cli_mb * MiB
    flat, _ = workload(args)
    inp = os.path.join(WORK, "cli_in.bin")
    merges = os.path.join(WORK, "merges.txt")
    write_corpus_file(inp, args.seed + 2, size)
    write_merges_file(merges, flat)
    env = dict(os.environ, BLT_LOG="info")
    engine = "shard" if args.cards > 1 else "jax"
    modes = [("basic", []), ("bpe", ["--merges", merges])]
    if args.cards == 1:
        modes.append(("passthrough", ["--passthrough", "--type", "bin"]))
    for mode, extra in modes:
        out_dev = os.path.join(WORK, "out_device.bin")
        out_host = os.path.join(WORK, "out_host.bin")
        argv = ["-i", inp, "-o", out_dev, *extra]
        if args.rehearse_on_cpu and mode != "passthrough":
            argv += ["--engine", engine]  # AUTO keeps a CPU host on numpy
        wall, log = run_cli(args, argv, env)
        if mode == "passthrough":
            # the identity map never visits the device: a kernel zero-copy
            # where the filesystem offers one, else the engine's host copy
            if "kernel zero-copy" in log:
                chosen = "kernel zero-copy (no engine)"
            else:
                require(f"passthrough strategy on {engine} engine" in log,
                        f"passthrough took neither route:\n{log[-2000:]}")
                chosen = f"{engine} engine's host copy (AUTO)"
        else:
            require(f"strategy on {engine} engine" in log,
                    f"the {engine} engine was not chosen:\n{log[-2000:]}")
            require(re.search(rf"Device engine {engine} on {args.cards} "
                              rf"{expected_platform(args)} device", log),
                    f"no {expected_platform(args)} device engine in the log")
            if not args.rehearse_on_cpu:
                require(f"AUTO device probe: gpu backend, {args.cards} "
                        f"device(s) -> {engine} engine" in log,
                        "the AUTO probe did not pick the device engine")
            chosen = f"{engine} engine (AUTO)"
            if args.cards > 1:
                m = re.search(r"Sharded batch rows on (\d+) devices: (.*)", log)
                require(m is not None and int(m.group(1)) == args.cards,
                        "batch rows are not on every device")
                say(f"{mode}: one batch's sharding.device_set: {m.group(2)}")
        wall_host, _ = run_cli(
            args, ["-i", inp, "-o", out_host, *extra, "--engine", "numpy"],
            env)
        out_size = os.path.getsize(out_dev)
        where = compare_files(out_dev, out_host)
        require(where is None, f"{mode}: device output differs from the "
                               f"host engine: {where}")
        say(f"CLI {mode} {size} B -> {out_size} B on the {chosen}: "
            f"{wall:.3f} s wall, {size / wall / 1e6:.1f} MB/s (the CLI's "
            f"wall rate on this card, process start and compiles "
            f"included); host engine (numpy + native) {wall_host:.3f} s; "
            f"every output byte identical to the host engine's")
        os.unlink(out_dev)
        os.unlink(out_host)
    os.unlink(inp)
    return {}


def wait_for_server(proc, port: int, timeout: float) -> None:
    import http.client

    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        require(proc.poll() is None,
                f"server exited early (rc {proc.returncode})")
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            if conn.getresponse().status == 200:
                conn.close()
                return
        except OSError:
            time.sleep(0.5)
    raise PhaseFailure(f"server not up within {timeout:.0f} s")


def phase_server(args) -> dict:
    import http.client
    import socket

    import numpy as np

    from blt_tpu.merges import MergeTable
    from blt_tpu.pipeline.engines import NumpyEngine
    from blt_tpu.server import tokenize_bytes_wire
    from blt_tpu.utils import synth

    flat, _ = workload(args)
    merges = os.path.join(WORK, "merges.txt")
    write_merges_file(merges, flat)
    table = MergeTable.build(flat)
    sizes = [int(float(s) * MiB) for s in args.serve_mb.split(",")]
    data = synth.zipf_text(args.seed + 3, max(sizes))
    host = NumpyEngine()
    for mode in ("basic", "bpe"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        log_path = os.path.join(WORK, f"server_{mode}.log")
        argv = [sys.executable, "-m", "blt_tpu.server", "--engine", "jax",
                "--port", str(port)]
        if mode == "bpe":
            argv += ["--merges", merges]
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(
                argv, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
                env=dict(os.environ, BLT_LOG="info"), start_new_session=True,
            )
        try:
            t0 = time.perf_counter()
            wait_for_server(proc, port, 300)
            say(f"blt-serve --engine jax ({mode}) up in "
                f"{time.perf_counter() - t0:.1f} s")
            for size in sizes:
                body = data[:size].tobytes()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                t0 = time.perf_counter()
                conn.request("POST", "/tokenize", body=body)
                resp = conn.getresponse()
                got = resp.read()
                dt = time.perf_counter() - t0
                conn.close()
                require(resp.status == 200,
                        f"POST {size} B: HTTP {resp.status}: {got[:300]!r}")
                want = tokenize_bytes_wire(
                    body, table=table if mode == "bpe" else None, engine=host)
                where = compare_bytes(got, want)
                require(where is None, f"{mode} {size} B: {where}")
                say(f"POST /tokenize {mode} {size} B: {dt:.3f} s (first "
                    f"request of its size bucket, compile included); "
                    f"{len(got)} B identical to the host engine")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            with open(log_path) as f:
                log = f.read()
            require(rc == 0, f"server shutdown rc {rc}:\n{log[-2000:]}")
            require(f"Device engine jax on 1 {expected_platform(args)} device"
                    in log, f"server not on the device:\n{log[-2000:]}")
            say(f"blt-serve ({mode}) shut down cleanly (SIGINT, rc 0)")
        finally:
            kill_group(proc)
    return {}


def phase_api(args) -> dict:
    import logging

    check_platform(args)
    import blt_tpu as blt

    _, hier = workload(args)
    size = args.api_mb * MiB
    inp = os.path.join(WORK, "api_in.bin")
    write_corpus_file(inp, args.seed + 4, size)
    seen = []

    class Capture(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger = logging.getLogger("blt_tpu")
    logger.setLevel(logging.INFO)
    logger.addHandler(Capture())
    engine = "shard" if args.cards > 1 else "jax"
    # one card: the jax engine by name; four: AUTO must pick the sharded one
    api_engine = "jax" if args.cards == 1 or args.rehearse_on_cpu else "auto"
    if args.rehearse_on_cpu and args.cards > 1:
        api_engine = "shard"
    outs = {}
    for name in (api_engine, "numpy"):
        out = os.path.join(WORK, f"api_out_{name}.bin")
        t0 = time.perf_counter()
        blt.ByteTokenizer(merges=hier, engine=name).tokenize_file(inp, out)
        outs[name] = (out, time.perf_counter() - t0)
    require(any(f"strategy on {engine} engine" in m for m in seen),
            f"the {engine} engine did not run the hierarchical table")
    where = compare_files(outs[api_engine][0], outs["numpy"][0])
    require(where is None, f"API output differs from the host engine: {where}")
    say(f"ByteTokenizer(merges=<{len(hier)} rules, hierarchical>, "
        f"engine={api_engine!r}).tokenize_file {size} B on the {engine} "
        f"engine (multi-pass): {outs[api_engine][1]:.3f} s; engine='numpy' "
        f"{outs['numpy'][1]:.3f} s; every output byte identical")
    return {}


def phase_gpu_tests(args) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu" if args.rehearse_on_cpu
               else "cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    say(f"pytest -m gpu: {tail}")
    require(r.returncode == 0, f"gpu tests failed:\n{r.stdout[-3000:]}")
    passed = re.search(r"(\d+) passed", tail)
    if not args.rehearse_on_cpu:
        require(passed is not None and "skipped" not in tail,
                "gpu tests did not all run on the card")
    return {}


PHASES = {
    "setup": phase_setup,
    "kernels": phase_kernels,
    "cli": phase_cli,
    "server": phase_server,
    "api": phase_api,
    "gpu_tests": phase_gpu_tests,
}


def child(args) -> int:
    try:
        result = PHASES[args.phase](args)
        ok = True
    except PhaseFailure as e:
        say(f"FAILED: {e}")
        result, ok = {}, False
    except Exception as e:  # any crash is this phase's failure, reported
        import traceback

        say(f"FAILED: {type(e).__name__}: {e}")
        traceback.print_exc()
        result, ok = {}, False
    print(RESULT_TAG + json.dumps(dict(result, ok=ok)), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cli-mb", type=int, default=1024,
                    help="CLI input size in MiB (default 1024)")
    ap.add_argument("--batch-mb", type=int, default=16,
                    help="device batch for the kernel checks (default 16)")
    ap.add_argument("--api-mb", type=int, default=64,
                    help="API input size in MiB (default 64)")
    ap.add_argument("--serve-mb", default="1,16,64",
                    help="server payload sizes in MiB (default 1,16,64)")
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="run the phases on JAX's CPU backend; never ok")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return child(args)
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
