"""End-to-end pipeline benchmarks mirroring the reference workloads.

Reference: benches/pipeline_benchmark.rs runs passthrough over generated
10MB / 100MB / 1GB files with Criterion (sample_size 10); its published
numbers (README.md:274-278) are passthrough-mode only. This harness runs
the same file sizes through the real pipeline in all three modes and also
BPE (which the reference never benchmarked), printing one JSON object per
workload.

Usage:
    python benches/pipeline_benchmark.py [--sizes 10MB,100MB] [--engine auto]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blt_tpu.config import CoreConfig, Engine  # noqa: E402
from blt_tpu.pipeline.runner import run_tokenizer  # noqa: E402

SIZES = {
    "10MB": 10 * 1024 * 1024,
    "100MB": 100 * 1024 * 1024,
    "256MB": 256 * 1024 * 1024,
    "1GB": 1 << 30,
}


def make_file(path: str, size: int) -> None:
    # zipf-ish text so BPE rules fire (the reference benches zero-filled
    # files, which trivializes BPE; text is the honest workload)
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"etaoinshrdlu cmfwyp", np.uint8)
    base = rng.choice(alphabet, size=4 * 1024 * 1024).astype(np.uint8)
    with open(path, "wb") as f:
        written = 0
        while written < size:
            n = min(base.shape[0], size - written)
            f.write(base[:n].tobytes())
            written += n


def run_once(input_path, output_path, mode, engine, merges_path=None):
    config = CoreConfig.new_from_cli(
        input=input_path,
        output=output_path,
        merges=merges_path if mode in ("bpe", "decode") else None,
        passthrough=(mode == "passthrough"),
        decode=(mode == "decode"),
        engine=engine,
    )
    t0 = time.perf_counter()
    run_tokenizer(config)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="10MB,100MB")
    ap.add_argument("--engine", default="auto", choices=["auto", "jax", "numpy"])
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--out", default=None, help="write a JSON artifact here")
    ap.add_argument("--modes", default="passthrough,basic,bpe")
    args = ap.parse_args()
    engine = Engine(args.engine)
    records = []
    artifact = {"engine": args.engine, "workloads": records}

    with tempfile.TemporaryDirectory() as td:
        merges = os.path.join(td, "merges.txt")
        with open(merges, "w") as f:
            for i, (a, b) in enumerate([(101, 116), (116, 97), (97, 111), (32, 101)]):
                f.write(f"{a} {b}\n")
        for name in args.sizes.split(","):
            size = SIZES[name.strip()]
            ip = os.path.join(td, f"in_{name}.bin")
            op = os.path.join(td, "out.bin")
            make_file(ip, size)
            for mode in args.modes.split(","):
                src, nbytes = ip, size
                if mode == "decode":
                    # decode consumes a token wire stream: encode once
                    # (untimed), then time the inverse direction
                    src = os.path.join(td, f"wire_{name}.bin")
                    run_once(ip, src, "bpe", engine, merges)
                    nbytes = os.path.getsize(src)
                times = [
                    run_once(src, op, mode, engine, merges)
                    for _ in range(args.samples)
                ]
                if mode == "decode":
                    os.unlink(src)
                best = min(times)
                rec = {
                    "workload": f"{mode}_{name}",
                    "bytes": nbytes,
                    "best_seconds": best,
                    "bytes_per_sec": nbytes / best,
                    "samples": args.samples,
                    "engine": engine.value,
                }
                records.append(rec)
                print(json.dumps(rec), flush=True)
            os.unlink(ip)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)


if __name__ == "__main__":
    main()
