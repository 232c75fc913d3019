"""HTTP tokenization service.

The reference's architecture diagram and roadmap list a REST API that was
never implemented (reference: ARCHITECTURE.md:49, README.md:399,
CHANGELOG.md:11-13 — verified absent from the code, SURVEY.md §1). This
module implements it: a small stdlib-only threaded HTTP server exposing
the same three tokenization modes with the exact CLI/pipeline semantics
(mode truth table lib.rs:271-282, content-type header lib.rs:284-294).

Endpoints:
    GET  /health            -> {"status": "ok"}
    GET  /version           -> {"version": "..."}
    POST /tokenize          -> request body bytes in, u16-BE token wire out
         query params: mode=auto|passthrough (default auto: BPE when the
                       server was started with --merges, else basic);
                       type=text|audio|bin|video (optional header token)
    POST /detokenize        -> u16-BE token wire in, original bytes out
         query params: type=... (verify + strip the header token); uses
                       the server's --merges table for rule expansion

Run:  python -m blt_tpu.server [--port 8149] [--merges FILE] [--threads N]

Requests are tokenized on the host engine (NumPy/C++ native): service
payloads are latency-bound, where device dispatch overhead dominates —
the same policy as the CLI's AUTO engine for small inputs.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from blt_tpu._version import __version__
from blt_tpu.config import ContentType
from blt_tpu.merges import MergeTable, load_bpe_merges_from_path
from blt_tpu.pipeline.engines import NumpyEngine
from blt_tpu.utils.logging import configure, get_logger

log = get_logger("server")


def tokenize_bytes_wire(
    data: bytes,
    table: Optional[MergeTable] = None,
    passthrough: bool = False,
    content_type: Optional[ContentType] = None,
    engine: Optional[NumpyEngine] = None,
) -> bytes:
    """In-memory bytes -> u16-BE wire stream with full pipeline semantics.

    Mode truth table identical to lib.rs:271-282; the content-type header
    is prepended for every mode (lib.rs:254-263).
    """
    from blt_tpu.pipeline.engines import device_capacity_hint

    engine = engine or NumpyEngine()
    arr = np.frombuffer(data, dtype=np.uint8)
    if hasattr(engine, "select"):  # PayloadAutoEngine: per-request choice
        engine = engine.select(arr.size)
    chunks = iter([arr]) if arr.size else iter(())
    # Device engines bucket the encoder capacity to powers of two so a
    # serving process reuses one compiled program per bucket instead of
    # recompiling per distinct payload size (engines.device_capacity_hint).
    hint = device_capacity_hint(arr.size, engine)
    if passthrough:
        stream = engine.passthrough_stream(chunks, hint)
    elif table is not None and len(table):
        stream = engine.bpe_stream(chunks, table, hint)
    else:
        stream = engine.basic_stream(chunks, hint)
    header = (
        content_type.token_value.to_bytes(2, "big") if content_type else b""
    )
    return header + b"".join(bytes(part) for part in stream)


def detokenize_wire_bytes(
    data: bytes,
    table: Optional[MergeTable] = None,
    content_type: Optional[ContentType] = None,
    exp_table=None,
) -> bytes:
    """In-memory u16-BE wire stream -> original bytes (ops/decode.py).

    ``exp_table`` lets long-lived callers (the server) reuse a prebuilt
    ExpansionTable instead of rebuilding it per request.
    """
    from blt_tpu.ops.decode import (
        build_expansion_table,
        decode_wire,
        odd_trailing_error,
        verify_strip_header,
    )

    if len(data) % 2:
        raise odd_trailing_error()
    data = verify_strip_header(data, content_type)
    if exp_table is None:
        exp_table = build_expansion_table(table.merges if table is not None else None)
    return decode_wire(np.frombuffer(data, np.uint8), exp_table).tobytes()


class _Handler(BaseHTTPRequestHandler):
    server_version = f"blt-tpu/{__version__}"
    # set by serve(): table, engine, exp_table (decode expansions, built once)
    table: Optional[MergeTable] = None
    engine: Optional[NumpyEngine] = None
    exp_table = None

    def log_message(self, fmt, *args):  # route access logs through BLT_LOG
        log.debug("%s %s", self.address_string(), fmt % args)

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/health":
            self._json(200, {"status": "ok"})
        elif path == "/version":
            self._json(200, {"version": __version__})
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path not in ("/tokenize", "/detokenize"):
            self._json(404, {"error": f"unknown path {url.path}"})
            return
        params = parse_qs(url.query)
        mode = params.get("mode", ["auto"])[0]
        type_name = params.get("type", [None])[0]
        if mode not in ("auto", "passthrough"):
            self._json(400, {"error": f"unknown mode '{mode}'"})
            return
        content_type = None
        if type_name is not None:
            try:
                content_type = ContentType.from_cli(type_name)
            except KeyError:
                self._json(400, {"error": f"unknown type '{type_name}'"})
                return
        if (self.headers.get("Transfer-Encoding", "").lower() == "chunked"
                and "Content-Length" not in self.headers):
            self._json(411, {"error": "chunked bodies are not supported; "
                                      "send Content-Length"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._json(400, {"error": "malformed Content-Length"})
            return
        if length < 0:
            self._json(400, {"error": "negative Content-Length"})
            return
        data = self.rfile.read(length) if length else b""
        try:
            if url.path == "/detokenize":
                wire = detokenize_wire_bytes(
                    data, table=self.table, content_type=content_type,
                    exp_table=self.exp_table,
                )
            else:
                wire = tokenize_bytes_wire(
                    data,
                    table=self.table,
                    passthrough=(mode == "passthrough"),
                    content_type=content_type,
                    engine=self.engine,
                )
        except ValueError as e:  # malformed stream / table: client error
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # tokenization failure -> 500, not a crash
            log.error("tokenize failed: %s", e)
            self._json(500, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(wire)))
        self.end_headers()
        self.wfile.write(wire)


def make_server(
    host: str = "127.0.0.1",
    port: int = 8149,
    merges_path: Optional[Path] = None,
    threads: int = 0,
    engine: str = "numpy",
    warmup_bytes: int = 0,
    device_threshold: Optional[int] = None,
) -> ThreadingHTTPServer:
    """Build a ready-to-serve HTTP server (port 0 = ephemeral, for tests).

    engine="numpy" (default) serves on the host engine — service payloads
    are usually latency-bound, where device dispatch overhead dominates.
    engine="jax"/"shard" serves large-batch workloads on the accelerator
    (one engine instance shared across the handler pool; engine streams
    are re-entrant per request since each request runs its own stream).
    engine="auto" applies the CLI's AUTO policy PER REQUEST: payloads
    below ``device_threshold`` (default engines.AUTO_DEVICE_THRESHOLD;
    tune per deployment) stay on the host engine, larger ones use the accelerator when one
    exists.
    """
    table = None
    if merges_path is not None:
        table = MergeTable.build(load_bpe_merges_from_path(merges_path))
    if engine == "jax":
        from blt_tpu.pipeline.engines import JaxEngine

        eng = JaxEngine(threads=threads)
    elif engine == "shard":
        from blt_tpu.pipeline.engines import ShardedJaxEngine

        eng = ShardedJaxEngine(threads=threads)
    elif engine == "auto":
        from blt_tpu.pipeline.engines import PayloadAutoEngine

        eng = PayloadAutoEngine(threads, device_threshold=device_threshold)
    else:
        eng = NumpyEngine(threads)
    from blt_tpu.ops.decode import build_expansion_table

    try:
        exp_table = build_expansion_table(
            table.merges if table is not None else None
        )
    except ValueError:
        # non-invertible table: the server still tokenizes; /detokenize
        # reports the build error per request
        exp_table = None
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"table": table, "engine": eng, "exp_table": exp_table},
    )
    if warmup_bytes > 0:
        _warmup(eng, table, warmup_bytes)
    return ThreadingHTTPServer((host, port), handler)


def _warmup(engine, table: Optional[MergeTable], max_bytes: int) -> None:
    """Pre-compile the device programs for every capacity bucket <= max_bytes.

    One tokenize per power-of-two bucket in the server's serving mode, so
    the first real request of any size pays zero XLA compiles.
    Always warms at least the floor bucket (every small request maps to
    it). Host engines have no compile step: nothing to warm.
    """
    from blt_tpu.pipeline.engines import DEVICE_HINT_FLOOR

    if getattr(engine, "name", "") == "auto":
        if engine.threshold > max(max_bytes, DEVICE_HINT_FLOOR):
            # nothing to warm (and no point probing the device): every
            # bucket up to --warmup SIZE routes to the host engine
            log.warning(
                "warmup: --warmup %d is below the AUTO device threshold "
                "%d — no device buckets to pre-compile (raise --warmup "
                "or lower --device-threshold)", max_bytes, engine.threshold,
            )
            return
        # warm the device side for payloads the threshold routes there
        dev = engine.select(engine.threshold)
        if getattr(dev, "name", "") not in ("jax", "shard"):
            log.info("warmup: AUTO has no device engine; skipping")
            return
        size = DEVICE_HINT_FLOOR
        while size <= max(max_bytes, DEVICE_HINT_FLOOR):
            if size >= engine.threshold:
                log.info("warmup: %d-byte bucket (auto->device)", size)
                tokenize_bytes_wire(b"\x00" * size, table=table, engine=dev)
            size <<= 1
        return
    if getattr(engine, "name", "") not in ("jax", "shard"):
        log.info("warmup: host engine has no compile step; skipping")
        return
    size = DEVICE_HINT_FLOOR
    while size <= max(max_bytes, DEVICE_HINT_FLOOR):
        log.info("warmup: %d-byte bucket", size)
        tokenize_bytes_wire(b"\x00" * size, table=table, engine=engine)
        size <<= 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    configure()
    p = argparse.ArgumentParser(
        prog="blt-serve", description="HTTP tokenization service"
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8149)
    p.add_argument("--merges", metavar="FILE", default=None,
                   help="BPE merges file (server tokenizes in BPE mode)")
    p.add_argument("--threads", type=int, default=0,
                   help="Host engine worker threads (0 = auto)")
    p.add_argument("--engine", default="numpy",
                   choices=["numpy", "jax", "shard", "auto"],
                   help="Compute backend (numpy: latency-bound payloads; "
                        "jax/shard: large-batch device serving; auto: "
                        "per-request threshold policy)")
    p.add_argument("--device-threshold", metavar="SIZE", default=None,
                   help="With --engine auto: payloads >= SIZE (e.g. 1MB) "
                        "use the accelerator, smaller ones the host "
                        "engine (default 32MB)")
    p.add_argument("--warmup", metavar="SIZE", default=None,
                   help="Pre-compile device programs for every payload "
                        "bucket up to SIZE (e.g. 16MB) before serving")
    args = p.parse_args(argv)
    from blt_tpu.utils.parsing import parse_chunk_size_str

    warmup_bytes = 0
    device_threshold = None
    try:
        if args.warmup is not None:
            warmup_bytes = parse_chunk_size_str(args.warmup)
        if args.device_threshold is not None:
            device_threshold = parse_chunk_size_str(args.device_threshold)
    except ValueError as e:
        print(f"Error starting server: {e}", file=sys.stderr)
        return 1
    try:
        server = make_server(
            args.host, args.port,
            Path(args.merges) if args.merges else None, args.threads,
            engine=args.engine,
            warmup_bytes=warmup_bytes,
            device_threshold=device_threshold,
        )
    except (OSError, ValueError) as e:
        print(f"Error starting server: {e}", file=sys.stderr)
        return 1
    log.info("Serving on %s:%d", *server.server_address[:2])
    print(f"blt-tpu serving on http://{args.host}:{server.server_address[1]}",
          file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
