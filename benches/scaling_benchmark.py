#!/usr/bin/env python3
"""Scaling-efficiency benchmark: bytes/s/chip at mesh sizes 1..N.

The BASELINE.json target is >= 80% multi-host scaling efficiency measured
at 1 chip / 1 host / N hosts. This harness times the sharded flat-BPE
encode (row-sharded corpus, replicated merges, carry-composition
collectives — blt_tpu/parallel/sharded.py) over meshes of increasing size
and reports throughput per chip and efficiency vs the 1-device run.

On a multi-host cluster, run one process per host after
blt_tpu.parallel.distributed.initialize(); every host executes the same
program. Without accelerators it validates the harness on virtual CPU
devices (XLA_FLAGS=--xla_force_host_platform_device_count=8), where the
absolute numbers are meaningless but sharding, collectives, and
bit-exactness are real.

``--decompose`` additionally separates WHERE virtual-mesh efficiency goes
on an oversubscribed host, with two controls per mesh size:

  rowlocal   the same per-row compute with NO collectives (carry scan and
             next-byte shuffle removed, parallel.sharded.
             sharded_flat_encode_rowlocal): sharded/rowlocal isolates the
             partitioner+collective cost of exactness.
  solo x N   N INDEPENDENT single-device processes running concurrently
             (no partitioner at all): their aggregate rate is the host's
             resource ceiling (cores + memory bandwidth) that perfect
             sharding cannot exceed. sharded_aggregate/solo_aggregate is
             the honest "efficiency vs what this host could ever do".

Usage:
    python benches/scaling_benchmark.py [--mesh-sizes 1,2,4,8] [--mb 8]
    python benches/scaling_benchmark.py --cpu --decompose
    python benches/scaling_benchmark.py --processes 1,2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ALPHABET = b"etaoinshrdlu cmfwyp"


def build_corpus_table(rng, n_rules: int = 200):
    """English-letter-frequency corpus alphabet + a merges table of its
    most frequent pairs."""
    from blt_tpu.merges import MergeTable

    alphabet = np.frombuffer(_ALPHABET, np.uint8)
    sample = rng.choice(alphabet, size=65536).astype(np.uint8)
    pairs, counts = np.unique(
        sample[:-1].astype(np.int32) * 256 + sample[1:], return_counts=True
    )
    merges = {}
    vocab = 256
    for p in pairs[np.argsort(-counts)][:n_rules]:
        merges[(int(p) // 256, int(p) % 256)] = vocab
        vocab += 1
    return alphabet, MergeTable.build(merges)


def run_processes(nproc: int, mb_total: float, merges_lines: str) -> dict:
    """Multi-PROCESS scaling: N real jax.distributed workers, one shared
    output file, through the public multi-host runner (parallel/multihost).

    Each worker reports its own interpreter-import and run wall times, so
    the aggregate throughput can be quoted with startup excluded; a
    second tiny-input run measures the fixed post-import overhead
    (jax.distributed init + compiles) for the steady-state rate.
    """
    import socket
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    size = int(mb_total * 1024 * 1024)

    worker = (
        "import sys, time, json\n"
        "t0 = time.perf_counter()\n"
        "import jax\n"
        "from blt_tpu.cli import main\n"
        "t1 = time.perf_counter()\n"
        "rc = main(sys.argv[1:])\n"
        "t2 = time.perf_counter()\n"
        "print(json.dumps({'import_s': t1 - t0, 'run_s': t2 - t1}))\n"
        "sys.exit(rc)\n"
    )

    def one_run(run_size: int) -> dict:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as td:
            ip = os.path.join(td, "in.bin")
            op = os.path.join(td, "out.bin")
            mp = os.path.join(td, "m.txt")
            rng = np.random.default_rng(0)
            alphabet = np.frombuffer(_ALPHABET, np.uint8)
            rng.choice(alphabet, size=run_size).astype(np.uint8).tofile(ip)
            with open(mp, "w") as f:
                f.write(merges_lines)
            cli = ["-i", ip, "-o", op, "--merges", mp, "--engine", "numpy"]

            def env_for(pid):
                env = dict(os.environ)
                env["PYTHONPATH"] = repo + os.pathsep + env.get(
                    "PYTHONPATH", ""
                )
                # host-engine processes: several per machine, none on a card
                env["JAX_PLATFORMS"] = "cpu"
                if nproc > 1:
                    env["BLT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
                    env["BLT_NUM_PROCESSES"] = str(nproc)
                    env["BLT_PROCESS_ID"] = str(pid)
                return env

            t0 = time.perf_counter()
            procs = [
                subprocess.Popen(
                    [sys.executable, "-c", worker] + cli, env=env_for(pid),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                )
                for pid in range(nproc)
            ]
            timings = []
            for p in procs:
                out, err = p.communicate(timeout=600)
                assert p.returncode == 0, err.decode()
                timings.append(json.loads(out.splitlines()[-1]))
            dt = time.perf_counter() - t0
            out_bytes = os.path.getsize(op)
        return {
            "wall_seconds": dt,
            "output_bytes": out_bytes,
            "run_s_max": max(t["run_s"] for t in timings),
            "import_s_max": max(t["import_s"] for t in timings),
        }

    # the fixed cost (interpreter + jax.distributed handshake) jitters
    # 0.3-1.3s run to run — far above the marginal work for small sizes —
    # so both legs repeat and the steady rate uses medians
    reps = 3
    tinies = [one_run(64 * 1024) for _ in range(reps)]
    fulls = [one_run(size) for _ in range(reps)]
    tiny_med = float(np.median([t["run_s_max"] for t in tinies]))
    full_med = float(np.median([f["run_s_max"] for f in fulls]))
    steady = full_med - tiny_med
    return {
        "processes": nproc,
        "input_bytes": size,
        "output_bytes": fulls[0]["output_bytes"],
        "wall_seconds": float(np.median([f["wall_seconds"] for f in fulls])),
        "bytes_per_sec_aggregate": size / full_med,
        "run_seconds_max_reps": [f["run_s_max"] for f in fulls],
        "import_seconds_max": fulls[0]["import_s_max"],
        "fixed_overhead_seconds_reps": [t["run_s_max"] for t in tinies],
        "bytes_per_sec_steady": size / steady if steady > 0 else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-sizes", default="")
    ap.add_argument("--mb", type=float, default=8.0, help="MB per device")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--decompose", action="store_true",
        help="also run the no-collective and independent-process controls",
    )
    ap.add_argument(
        "--processes", default="",
        help="comma list of process counts: multi-process (jax.distributed) "
             "host-scaling mode, e.g. --processes 1,2",
    )
    # hidden: one independent single-device worker of the solo control
    ap.add_argument("--solo-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ready", default="", help=argparse.SUPPRESS)
    ap.add_argument("--go", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dur", type=float, default=4.0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.solo_child:
        run_solo_child(args.mb, args.ready, args.go, args.dur)
        return

    if args.processes:
        merges_lines = "101 116\n116 97\n97 111\n32 101\n"
        base = None
        for n in [int(x) for x in args.processes.split(",") if x]:
            rec = run_processes(n, args.mb, merges_lines)
            if base is None:
                base = rec["bytes_per_sec_steady"] or rec[
                    "bytes_per_sec_aggregate"
                ]
            steady = rec["bytes_per_sec_steady"] or rec[
                "bytes_per_sec_aggregate"
            ]
            rec["scaling_efficiency_vs_1proc"] = steady / (
                base * rec["processes"]
            )
            print(json.dumps(rec), flush=True)
        return

    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    sizes = [int(s) for s in args.mesh_sizes.split(",") if s] or None
    if args.decompose:
        print(json.dumps(run_decomposition(
            jax, mb_per_dev=args.mb, iters=args.iters, sizes=sizes
        ), indent=1))
        return
    for rec in run_mesh_scaling(
        jax, mb_per_dev=args.mb, iters=args.iters, sizes=sizes
    ):
        print(json.dumps(rec))


def _timed_step(jax, step, step_args, iters: int) -> float:
    """Seconds for ``iters`` dispatches of a warmed-up jitted step."""
    out = step(*step_args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*step_args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def run_mesh_scaling(jax, mb_per_dev: float = 8.0, iters: int = 5,
                     sizes=None, rowlocal: bool = False) -> list:
    """Time the sharded flat-BPE encode over meshes of 1..N devices.

    Returns one record per mesh size with bytes/s/chip and efficiency vs
    the 1-device run (compile excluded: the step is warmed before
    timing). ``rowlocal`` swaps in the
    no-collective control variant (see module docstring).
    """
    from blt_tpu.ops.bpe_numpy import bpe_encode_flat
    from blt_tpu.parallel.mesh import (
        make_mesh,
        replicated,
        row_sharding,
        vec_sharding,
    )
    from blt_tpu.parallel.sharded import (
        sharded_flat_encode,
        sharded_flat_encode_rowlocal,
    )
    from blt_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    devices = jax.devices()
    if sizes is None:
        sizes = sorted(
            {1, 2, len(devices)} & set(range(1, len(devices) + 1))
        ) or [1]
    sizes = [s for s in sizes if s <= len(devices)]

    per_dev = int(mb_per_dev * 1024 * 1024)
    rng = np.random.default_rng(0)
    alphabet, table = build_corpus_table(rng)

    base_bps = None
    results = []
    for n_dev in sizes:
        mesh = make_mesh(devices[:n_dev])
        rows = row_sharding(mesh)
        vec = vec_sharding(mesh)
        rep = replicated(mesh)
        batch = rng.choice(alphabet, size=(n_dev, per_dev)).astype(np.uint8)
        lengths = np.full(n_dev, per_dev, np.int32)
        batch_d = jax.device_put(batch, rows)
        lengths_d = jax.device_put(lengths, vec)
        dense_d = jax.device_put(table.dense, rep)
        if rowlocal:
            step = jax.jit(
                sharded_flat_encode_rowlocal,
                in_shardings=(rows, vec, rep),
                out_shardings=(rows, vec),
            )
        else:
            step = jax.jit(
                sharded_flat_encode,
                in_shardings=(rows, vec, rep),
                out_shardings=(rows, vec, rep),
            )
            tokens, counts_out, _ = step(batch_d, lengths_d, dense_d)
            jax.block_until_ready((tokens, counts_out))
            # Check the assembled stream against the host oracle: rows are
            # one contiguous stream (cross-row carries), so per-row
            # comparison against independent row encodes would be wrong at
            # row tails.
            tokens_h, counts_h = np.asarray(tokens), np.asarray(counts_out)
            got = np.concatenate(
                [tokens_h[r, : counts_h[r]] for r in range(n_dev)]
            )
            exp = bpe_encode_flat(batch.reshape(-1), table)
            assert got.tolist() == exp.tolist(), "sharded encode mismatch"

        dt = _timed_step(jax, step, (batch_d, lengths_d, dense_d), iters)
        total = n_dev * per_dev * iters
        bps_chip = total / dt / n_dev
        if base_bps is None:
            base_bps = bps_chip
        results.append(
            {
                "mesh_devices": n_dev,
                "bytes_per_sec_per_chip": bps_chip,
                "scaling_efficiency_vs_1": bps_chip / base_bps,
                "backend": jax.default_backend(),
            }
        )
    return results


def run_solo_child(mb: float, ready_path: str, go_path: str,
                   dur: float) -> None:
    """One independent single-device worker of the solo control: warm up,
    signal ready, wait for the shared GO file, then run dispatches for
    ``dur`` seconds and print the bytes processed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from blt_tpu.parallel.sharded import sharded_flat_encode

    per_dev = int(mb * 1024 * 1024)
    rng = np.random.default_rng(0)
    alphabet, table = build_corpus_table(rng)
    batch = rng.choice(alphabet, size=(1, per_dev)).astype(np.uint8)
    lengths = np.full(1, per_dev, np.int32)
    import jax.numpy as jnp

    batch_d = jnp.asarray(batch)
    lengths_d = jnp.asarray(lengths)
    dense_d = jnp.asarray(table.dense)
    out = sharded_flat_encode(batch_d, lengths_d, dense_d)
    jax.block_until_ready(out)
    with open(ready_path, "w") as f:
        f.write("ready")
    while not os.path.exists(go_path):
        time.sleep(0.02)
    done = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < dur:
        out = sharded_flat_encode(batch_d, lengths_d, dense_d)
        jax.block_until_ready(out)
        done += per_dev
    dt = time.perf_counter() - t0
    print(json.dumps({"bytes": done, "seconds": dt}))


def run_independent_processes(n: int, mb: float, dur: float = 4.0) -> dict:
    """Aggregate rate of ``n`` concurrent single-device processes — the
    host resource ceiling with zero partitioner/collective involvement."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        go = os.path.join(td, "go")
        readies = [os.path.join(td, f"r{i}") for i in range(n)]
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--solo-child",
                 "--mb", str(mb), "--ready", readies[i], "--go", go,
                 "--dur", str(dur)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            for i in range(n)
        ]
        deadline = time.time() + 300
        while not all(os.path.exists(r) for r in readies):
            if time.time() > deadline:
                for p in procs:
                    p.kill()
                raise TimeoutError("solo children never became ready")
            time.sleep(0.05)
        with open(go, "w") as f:
            f.write("go")
        rates = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()
            rec = json.loads(out.splitlines()[-1])
            rates.append(rec["bytes"] / rec["seconds"])
    return {
        "processes": n,
        "bytes_per_sec_aggregate": sum(rates),
        "bytes_per_sec_min": min(rates),
        "bytes_per_sec_max": max(rates),
    }


def run_decomposition(jax, mb_per_dev: float = 4.0, iters: int = 5,
                      sizes=None) -> dict:
    """Virtual-mesh scaling with the two controls + derived attribution.

    For each mesh size n:
      collective_cost_frac  = 1 - sharded_rate / rowlocal_rate
                              (what exactness costs: partitioner +
                              carry-scan collectives, same mesh)
      efficiency_vs_host_ceiling = sharded_aggregate / solo_aggregate(n)
                              (what sharding achieves of the best this
                              host could possibly do with n workers —
                              the honest efficiency once core
                              oversubscription and memory-bandwidth
                              contention are accounted as host limits,
                              not sharding losses)
    """
    host_cpus = os.cpu_count() or 1
    devices = jax.devices()
    if sizes is None:
        sizes = [s for s in (1, 2, 4, 8) if s <= len(devices)]
    sharded = run_mesh_scaling(jax, mb_per_dev, iters, sizes)
    rowlocal = run_mesh_scaling(jax, mb_per_dev, iters, sizes, rowlocal=True)
    solos = {n: run_independent_processes(n, mb_per_dev) for n in sizes}
    rows = []
    for sh, rl in zip(sharded, rowlocal):
        n = sh["mesh_devices"]
        solo = solos[n]
        sh_agg = sh["bytes_per_sec_per_chip"] * n
        rows.append({
            "mesh_devices": n,
            "sharded_bytes_per_sec_per_chip": sh["bytes_per_sec_per_chip"],
            "rowlocal_bytes_per_sec_per_chip": rl["bytes_per_sec_per_chip"],
            "solo_processes_aggregate": solo["bytes_per_sec_aggregate"],
            "sharded_aggregate": sh_agg,
            "raw_efficiency_vs_1": sh["scaling_efficiency_vs_1"],
            "collective_cost_frac": 1.0 - (
                sh["bytes_per_sec_per_chip"] / rl["bytes_per_sec_per_chip"]
            ),
            "efficiency_vs_host_ceiling": sh_agg / solo[
                "bytes_per_sec_aggregate"
            ],
        })
    return {
        "artifact": "scaling_decomposition",
        "host_cpus": host_cpus,
        "mb_per_dev": mb_per_dev,
        "note": (
            "Virtual CPU mesh on an oversubscribed host: raw_efficiency "
            "conflates sharding quality with core/memory contention. "
            "collective_cost_frac isolates the partitioner+collective "
            "price of exactness (same mesh, collectives removed); "
            "efficiency_vs_host_ceiling compares the sharded aggregate "
            "against N independent processes — everything below 1.0 "
            "there is attributable to the partitioner/runtime, "
            "everything between that and raw efficiency is host "
            "resource contention that no sharding scheme could recover."
        ),
        "rows": rows,
    }


if __name__ == "__main__":
    main()
