"""Serving-path latency benchmark: warm request latency through blt-serve.

Measures what a client of the HTTP service actually sees (reference has no
serving path; the REST API exists only in its roadmap, ARCHITECTURE.md:49):
POST /tokenize round-trip latency per payload size, host engine vs device
engine, after `--warmup`-equivalent pre-compilation (power-of-two capacity
bucketing + warmup => no compiles on the request path).

Run: python benches/serving_benchmark.py [--engines numpy,jax]
Prints one JSON object naming the device it ran on.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = [4 * 1024, 64 * 1024, 1024 * 1024, 4 * 1024 * 1024]
REPS = 8
WARM_REPS = 2


def log(m):
    print(m, file=sys.stderr, flush=True)


def bench_engine(engine: str, merges_path: str, corpus: np.ndarray) -> dict:
    from blt_tpu.server import make_server

    srv = make_server(
        port=0,
        merges_path=merges_path,
        engine=engine,
        warmup_bytes=max(SIZES) if engine in ("jax", "shard") else 0,
    )
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    results = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        for size in SIZES:
            payload = corpus[:size].tobytes()
            lat = []
            out_len = 0
            for rep in range(WARM_REPS + REPS):
                t0 = time.perf_counter()
                conn.request("POST", "/tokenize", body=payload)
                resp = conn.getresponse()
                body = resp.read()
                dt = time.perf_counter() - t0
                assert resp.status == 200, (resp.status, body[:200])
                out_len = len(body)
                if rep >= WARM_REPS:
                    lat.append(dt)
            lat.sort()
            p50 = lat[len(lat) // 2]
            results[f"{size}"] = {
                "p50_ms": p50 * 1e3,
                "min_ms": lat[0] * 1e3,
                "max_ms": lat[-1] * 1e3,
                "mb_per_s_at_p50": size / p50 / 1e6,
                "out_bytes": out_len,
            }
            log(
                f"{engine} {size//1024}KB: p50 {p50*1e3:.1f} ms "
                f"({size/p50/1e6:.1f} MB/s), min {lat[0]*1e3:.1f} ms"
            )
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engines", default="numpy,jax")
    args = ap.parse_args()

    import tempfile

    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"etaoinshrdlu ETAOIN,.!?", np.uint8)
    w = 1.0 / np.arange(1, len(alphabet) + 1)
    corpus = rng.choice(alphabet, size=max(SIZES), p=w / w.sum()).astype(
        np.uint8
    )
    sample = corpus[: 1 << 20]
    pairs, counts = np.unique(
        sample[:-1].astype(np.int32) * 256 + sample[1:].astype(np.int32),
        return_counts=True,
    )
    top = pairs[np.argsort(-counts)][:500]

    out = {
        "artifact": "serving_latency",
        "protocol": (
            f"POST /tokenize, BPE mode (500 rules), {REPS} timed reps "
            f"after {WARM_REPS} warm + full bucket warmup; in-process "
            "ThreadingHTTPServer over loopback"
        ),
        "engines": {},
    }
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for p in top:
            f.write(f"{int(p)//256} {int(p)%256}\n")
        merges_path = f.name
    try:
        import jax

        dev = jax.devices()[0]
        out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
        for engine in args.engines.split(","):
            log(f"--- engine {engine} ---")
            out["engines"][engine] = bench_engine(engine, merges_path, corpus)
    finally:
        os.unlink(merges_path)

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
