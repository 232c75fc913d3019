"""End-to-end differential fuzzer: pipeline output vs the semantics oracle.

Random corpora x random merge tables (flat and hierarchical) x random
chunk sizes x engines (numpy / jax / shard) x optional content-type
headers, all through the real ``run_tokenizer`` file path. Ground truth
is the pure-Python oracle (blt_tpu/ops/bpe_oracle.py, a literal
transcription of reference tokenizer.rs semantics); flat tables must be
chunk-size-invariant, general tables are compared per-chunk (the
reference's own chunked behavior, SURVEY.md 2.1.6).

Usage: python tools/fuzz_e2e.py [--trials 50] [--seed 0] [--max-bytes 200000]
A bounded version runs in CI as tests/test_pipeline.py::test_e2e_fuzz.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_table(rng: np.random.Generator, hierarchical: bool):
    n_rules = int(rng.integers(0, 40))
    merges = {}
    vocab = 256
    for _ in range(n_rules):
        a = int(rng.integers(0, 256))
        b = int(rng.integers(0, 256))
        merges[(a, b)] = vocab
        vocab += 1
    if hierarchical and merges:
        # add rules whose keys reference merged values (multi-pass only)
        for _ in range(int(rng.integers(1, 6))):
            existing = list(merges.values())
            a = int(rng.choice(existing))
            b = int(rng.integers(0, 256))
            merges[(a, b)] = vocab
            vocab += 1
    return merges


def make_corpus(rng: np.random.Generator, merges, max_bytes: int) -> bytes:
    n = int(rng.integers(0, max_bytes))
    if not merges or rng.random() < 0.2:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    # bias towards rule bytes so merges actually fire, with long runs
    # (hierarchical keys contain merged ids >= 256 — not corpus bytes)
    pool = [m for (a, b) in merges for m in (a, b) if m < 256]
    alphabet = np.array(sorted(set(pool))[:16] or [97], dtype=np.uint8)
    out = rng.choice(alphabet, size=n).astype(np.uint8)
    if n > 10 and rng.random() < 0.5:  # adversarial run of one byte
        k = int(rng.integers(2, n // 2))
        out[:k] = alphabet[0]
    return out.tobytes()


def one_trial(rng: np.random.Generator, trial: int, max_bytes: int) -> None:
    from blt_tpu.config import ContentType, CoreConfig, Engine
    from blt_tpu.merges import MergeTable
    from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
    from blt_tpu.pipeline.runner import run_tokenizer

    hierarchical = rng.random() < 0.3
    merges = make_table(rng, hierarchical)
    table = MergeTable.build(merges) if merges else None
    flat = table.flat if table else True
    data = make_corpus(rng, merges, max_bytes)
    ct = [ContentType.TEXT, ContentType.BIN, None][int(rng.integers(0, 3))]
    chunksize = f"{int(rng.choice([256, 300, 512, 1024]))}KB"

    header = ct.token_value.to_bytes(2, "big") if ct else b""
    if flat:
        expected = header + tokens_to_be_bytes(bpe_encode_oracle(data, merges))
    else:
        # general tables: per-chunk reference semantics at the effective
        # chunk size (pipeline feeds exactly effective-chunk batches)
        from blt_tpu.utils.chunking import get_effective_chunk_size
        from blt_tpu.utils.parsing import parse_chunk_size_str

        eff = get_effective_chunk_size(parse_chunk_size_str(chunksize), 1, None)
        parts = [
            tokens_to_be_bytes(
                bpe_encode_oracle(data[i : i + eff], merges)
            )
            for i in range(0, len(data), eff)
        ]
        expected = header + b"".join(parts)

    engines = [Engine.NUMPY, Engine.JAX, Engine.SHARD]
    with tempfile.TemporaryDirectory() as td:
        ip = os.path.join(td, "in.bin")
        with open(ip, "wb") as f:
            f.write(data)
        for engine in engines:
            op = os.path.join(td, f"out.{engine.value}")
            config = CoreConfig.new_from_cli(
                input=ip,
                output=op,
                content_type=ct,
                chunksize=chunksize,
                engine=engine,
            )
            if merges:
                config.with_merges(merges)
            run_tokenizer(config)
            with open(op, "rb") as f:
                got = f.read()
            assert got == expected, (
                f"trial {trial} engine={engine.value} flat={flat} "
                f"n={len(data)} rules={len(merges)} ct={ct} "
                f"chunk={chunksize}: {len(got)} vs {len(expected)} bytes"
            )

    # decode roundtrip: every invertible fuzzed table must satisfy
    # decode(encode(x)) == x through the real pipeline (ops/decode.py).
    # Fuzzed values are unique and >= 256, so invertibility only depends
    # on the expansion build succeeding (hierarchical chains stay acyclic
    # by construction: new rules only reference earlier values).
    with tempfile.TemporaryDirectory() as td:
        enc = os.path.join(td, "enc.bin")
        dec = os.path.join(td, "dec.bin")
        with open(enc, "wb") as f:
            f.write(expected)
        dconfig = CoreConfig.new_from_cli(
            input=enc, output=dec, content_type=ct, chunksize=chunksize,
            decode=True,
        )
        if merges:
            dconfig.with_merges(merges)
        run_tokenizer(dconfig)
        with open(dec, "rb") as f:
            back = f.read()
        if flat:
            assert back == data, (
                f"trial {trial}: decode roundtrip mismatch "
                f"({len(back)} vs {len(data)} bytes)"
            )
        else:
            # per-chunk encode of general tables still decodes to the
            # original bytes (expansion is position-independent)
            assert back == data, f"trial {trial}: hierarchical decode mismatch"

    # multi-host split planning: safe splits must be merge-transparent for
    # every fuzzed flat table/corpus (parallel/multihost.py)
    if flat and merges and len(data):
        from blt_tpu.ops.bpe_oracle import bpe_encode_oracle as oracle
        from blt_tpu.parallel import multihost

        nproc = int(rng.integers(2, 6))
        mm = np.frombuffer(data, np.uint8)
        bounds = multihost.safe_split_bounds(mm, table.dense, nproc)
        parts = [
            tokens_to_be_bytes(
                oracle(data[bounds[i] : bounds[i + 1]], merges)
            )
            for i in range(nproc)
        ]
        assert header + b"".join(parts) == expected, (
            f"trial {trial}: host-split assembly mismatch "
            f"(nproc={nproc}, bounds={bounds})"
        )


_MP_WORKER = """
import json, sys
import jax
spec = json.loads(sys.argv[1])
from blt_tpu.config import ContentType, CoreConfig, Engine
from blt_tpu.pipeline.runner import run_tokenizer
cfg = CoreConfig.new_from_cli(
    input=spec["input"], output=spec["output"],
    content_type=ContentType.from_cli(spec["ct"]) if spec["ct"] else None,
    chunksize=spec["chunksize"], passthrough=spec["passthrough"],
    decode=spec["decode"], engine=Engine.NUMPY,
)
if spec["merges"]:
    cfg.with_merges({(a, b): v for a, b, v in spec["merges"]})
run_tokenizer(cfg)
assert jax.process_count() == spec["nproc"], jax.process_count()
"""


def one_multiproc_trial(
    rng: np.random.Generator, trial: int, max_bytes: int = 100_000
) -> None:
    """REAL multi-process execution leg.

    Launches nproc actual ``jax.distributed`` CPU processes through the
    public runner (random corpus / table incl. hierarchical / mode incl.
    decode / explicit chunk size, exercising safe-split for flat tables
    and chunk-grid alignment for non-flat) writing ONE shared output
    file, and byte-compares against the single-process run. This fuzzes
    the multihost *execution* path (spool, all-gather, pwrite assembly),
    not just its planning math.
    """
    import json
    import socket
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hierarchical = rng.random() < 0.4
    merges = make_table(rng, hierarchical)
    passthrough = not merges and rng.random() < 0.3
    data = make_corpus(rng, merges, max_bytes)
    ct = [None, "text", "bin"][int(rng.integers(0, 3))]
    chunksize = f"{int(rng.choice([256, 300, 512]))}KB"
    nproc = int(rng.integers(2, 4))
    run_decode = bool(merges) and rng.random() < 0.4

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def launch(spec):
        def env_for(pid):
            env = dict(os.environ)
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            env["BLT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            env["BLT_NUM_PROCESSES"] = str(nproc)
            env["BLT_PROCESS_ID"] = str(pid)
            return env

        # stderr to temp files (not pipes): a chatty worker blocking on a
        # full pipe before the jax.distributed barrier would deadlock the
        # sequential reaping below
        errs = [
            tempfile.NamedTemporaryFile(prefix=f"blt_fuzz_err{pid}_")
            for pid in range(nproc)
        ]
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _MP_WORKER, json.dumps(spec)],
                env=env_for(pid),
                stdout=subprocess.DEVNULL,
                stderr=errs[pid],
            )
            for pid in range(nproc)
        ]
        try:
            for pid, p in enumerate(procs):
                p.wait(timeout=300)
                errs[pid].seek(0)
                assert p.returncode == 0, (
                    f"trial {trial} (mp): worker {pid} failed:\n"
                    f"{errs[pid].read().decode()}"
                )
        finally:
            # a failed/timed-out worker must not leave siblings blocked
            # on the dead coordinator
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for e in errs:
                e.close()

    from blt_tpu.config import ContentType, CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer

    ct_obj = ContentType.from_cli(ct) if ct else None
    merges_wire = [[a, b, v] for (a, b), v in merges.items()]
    with tempfile.TemporaryDirectory() as td:
        ip = os.path.join(td, "in.bin")
        with open(ip, "wb") as f:
            f.write(data)

        # single-process reference (same explicit chunk grid)
        op_ref = os.path.join(td, "ref.bin")
        cfg = CoreConfig.new_from_cli(
            input=ip, output=op_ref, content_type=ct_obj,
            chunksize=chunksize, passthrough=passthrough,
            engine=Engine.NUMPY,
        )
        if merges:
            cfg.with_merges(merges)
        run_tokenizer(cfg)
        with open(op_ref, "rb") as f:
            expected = f.read()

        op = os.path.join(td, "mp.bin")
        launch({
            "input": ip, "output": op, "ct": ct, "chunksize": chunksize,
            "passthrough": passthrough, "decode": False,
            "merges": merges_wire, "nproc": nproc,
        })
        with open(op, "rb") as f:
            got = f.read()
        assert got == expected, (
            f"trial {trial} (mp): {nproc}-process output mismatch "
            f"(n={len(data)} rules={len(merges)} ct={ct} "
            f"chunk={chunksize} passthrough={passthrough}: "
            f"{len(got)} vs {len(expected)} bytes)"
        )

        if run_decode and expected and not passthrough:
            dec = os.path.join(td, "dec.bin")
            launch({
                "input": op, "output": dec, "ct": ct,
                "chunksize": chunksize, "passthrough": False,
                "decode": True, "merges": merges_wire, "nproc": nproc,
            })
            with open(dec, "rb") as f:
                back = f.read()
            assert back == data, (
                f"trial {trial} (mp): {nproc}-process decode mismatch "
                f"({len(back)} vs {len(data)} bytes)"
            )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-bytes", type=int, default=200_000)
    ap.add_argument(
        "--multiproc-trials", type=int, default=0,
        help="additional trials launching REAL 2-3 process "
             "jax.distributed runs (slow: ~5s/trial of process startup)",
    )
    args = ap.parse_args()

    os.environ.setdefault("BLT_DEVICE_BATCH_BYTES", str(128 * 1024))
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    rng = np.random.default_rng(args.seed)
    for t in range(args.trials):
        one_trial(rng, t, args.max_bytes)
        if (t + 1) % 10 == 0:
            print(f"{t + 1}/{args.trials} trials ok", file=sys.stderr)
    for t in range(args.multiproc_trials):
        one_multiproc_trial(rng, t, args.max_bytes)
        print(f"multiproc {t + 1}/{args.multiproc_trials} ok", file=sys.stderr)
    print(
        f"fuzz: {args.trials} trials passed"
        + (f" + {args.multiproc_trials} multiproc" if args.multiproc_trials else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
