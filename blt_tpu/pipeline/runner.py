"""The tokenizer run loop: I/O setup, chunk feed, ordered drain.

Reference: blt_core/src/lib.rs:246-267 ``run_tokenizer`` +
blt_core/src/pipeline.rs (chunk fan-out and strict in-order reassembly).
Here ordering is free — chunks are fed and drained positionally — and
parallelism comes from the device pipeline (async dispatch depth) rather
than a thread pool. A dedicated writer thread overlaps disk writes with
compute, standing in for the reference's buffered async writer
(io_handler.rs:68-76).

Chunk-feed sizing:
- passthrough / basic / flat-BPE outputs are chunk-size invariant, so the
  device engine is fed large aligned batches (device_batch_bytes) regardless
  of the CLI chunk size, which only caps host memory;
- general (non-flat) BPE preserves the reference's per-chunk semantics, so
  chunks are exactly the effective chunk size (chunking.rs policy).
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, Optional

import numpy as np

from blt_tpu.config import CoreConfig, Mode
from blt_tpu.io.sources import OutputWriter, setup_io
from blt_tpu.pipeline.engines import AutoStreamEngine, JaxEngine, select_engine
from blt_tpu.utils.chunking import get_effective_chunk_size, mem_budget_bytes
from blt_tpu.utils.logging import get_logger, span
from blt_tpu.utils.profiling import maybe_profile

log = get_logger("runner")

DEVICE_BATCH_BYTES = 16 * 1024 * 1024


def _device_batch_bytes() -> int:
    """Device feed batch size; env-tunable (tests use small batches)."""
    return int(os.environ.get("BLT_DEVICE_BATCH_BYTES", DEVICE_BATCH_BYTES))


def _plan_feed_size(total, chunk: int, dev: int) -> int:
    """Device feed size for size-invariant modes: full ``dev``-sized
    batches, one shape shared by every large run, whatever the file size.

    Every distinct batch size is a distinct device compile, so the feed
    size never follows ``total``: a small file is one short batch and a
    large file's tail is one short final batch.
    """
    # an explicit --chunksize may RAISE the batch size
    return max(dev, chunk)


def run_tokenizer(config: CoreConfig) -> None:
    """Execute one tokenization run (lib.rs:246-267 orchestration)."""
    log.info("Starting tokenizer")
    from blt_tpu.parallel import multihost

    if multihost.env_distributed():
        # Multi-process contract set (BLT_COORDINATOR_ADDRESS et al.):
        # every host runs its byte range; see parallel/multihost.py.
        multihost.initialize_from_env()
        import jax

        if jax.process_count() > 1:
            multihost.run_tokenizer_distributed(config)
            return
    mode = config.mode
    effective_chunk_size = get_effective_chunk_size(
        config.cli_chunk_size, config.num_threads, config.mem_cap_percent
    )
    log.info("Chunk size determined: %d", effective_chunk_size)

    src, writer = setup_io(config.input, config.output)
    try:
        if mode == Mode.DECODE:
            from blt_tpu.ops.decode import build_expansion_table

            table = build_expansion_table(config.bpe_data)
            results = _decode_stream(
                src.chunks(effective_chunk_size), table, config.content_type,
                threads=config.num_threads,
            )
            with maybe_profile():
                _drain_to_writer(results, writer)
            log.info("Detokenizer run completed successfully")
            return

        if config.content_type is not None:
            writer.write(config.content_type.token_value.to_bytes(2, "big"))

        if mode == Mode.PASSTHROUGH:
            from blt_tpu.io.sources import kernel_copy

            # file->file identity map: kernel zero-copy (copy_file_range /
            # sendfile) — the bytes never enter user space. Falls through to
            # the engine stream for stdin/stdout or unsupported fd pairs.
            if kernel_copy(src, writer):
                log.info("Passthrough completed via kernel zero-copy")
                return

        engine = select_engine(
            config.engine,
            src.size,
            config.num_threads,
            mem_budget=mem_budget_bytes(config.mem_cap_percent),
        )
        log.info("Using %s strategy on %s engine", mode.value, engine.name)

        feed_size = effective_chunk_size
        invariant_output = mode in (Mode.BASIC, Mode.PASSTHROUGH) or (
            mode == Mode.BPE and config.table().flat
        )
        if isinstance(engine, (JaxEngine, AutoStreamEngine)) and invariant_output:
            feed_size = _plan_feed_size(
                src.size, effective_chunk_size, _device_batch_bytes()
            )

        chunks = src.chunks(feed_size)
        if mode == Mode.PASSTHROUGH:
            results = engine.passthrough_stream(chunks, feed_size)
        elif mode == Mode.BASIC:
            results = engine.basic_stream(chunks, feed_size)
        else:
            results = engine.bpe_stream(chunks, config.table(), feed_size)

        # BLT_PROFILE=<dir> captures the whole compute+drain phase (engines
        # are lazy generators, so compiles and kernels run inside the trace).
        with maybe_profile():
            _drain_to_writer(results, writer)
    except BaseException:
        # The cleanup close may itself raise (e.g. ENOSPC flushing buffered
        # data on a full disk) — swallow it so the unlink below still runs
        # and the ORIGINAL failure is what surfaces.
        try:
            writer.close()
        except OSError:
            pass
        # Deliberate improvement over the reference, which leaves a
        # truncated output file when a chunk fails mid-run (SURVEY.md 5:
        # "no partial-output cleanup"): a failed file-target run removes
        # its partial output so downstream consumers never see it.
        if writer.path is not None and str(writer.path) != "-":
            try:
                os.unlink(writer.path)
                log.info("Removed partial output %s after failure", writer.path)
            except OSError:
                pass
        raise
    finally:
        writer.close()
    log.info("Tokenizer run completed successfully")


def _decode_stream(
    chunks, table, content_type, threads: int = 0
) -> Iterator[np.ndarray]:
    """Stream u16-BE wire chunks through the detokenizer.

    Chunk boundaries may split a token (stream short reads are odd-length
    at will, io/sources.py), so a sub-token byte carries to the next chunk.
    With a content type configured, the leading header token is verified
    and stripped — the exact inverse of the encoder's prepend.
    """
    from blt_tpu.ops.decode import (
        decode_wire,
        header_mismatch_error,
        missing_header_error,
        odd_trailing_error,
    )

    carry = np.empty(0, dtype=np.uint8)
    header_pending = content_type is not None
    for chunk in chunks:
        if chunk.shape[0] == 0:
            continue
        data = np.concatenate([carry, chunk]) if carry.size else chunk
        if header_pending:
            if data.shape[0] < 2:
                carry = data.copy()
                continue
            tok = (int(data[0]) << 8) | int(data[1])
            if tok != content_type.token_value:
                raise header_mismatch_error(content_type, tok)
            data = data[2:]
            header_pending = False
        n = data.shape[0] & ~1
        if n:
            yield decode_wire(data[:n], table, threads)
        carry = data[n:].copy()
    if header_pending:
        # the encoder emits the header even for empty input, so a stream
        # ending first (even mid-header: a lone byte) is this error, not
        # the generic odd-trailing-byte one
        raise missing_header_error()
    if carry.size:
        raise odd_trailing_error()


def _drain_to_writer(results: Iterator, writer: OutputWriter) -> None:
    """Write ordered results, overlapping disk writes with compute.

    The per-chunk debug spans are the analog of the reference's
    ``process_chunk_task`` tracing spans (pipeline.rs:148,348).
    """
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        prev: Optional[concurrent.futures.Future] = None
        for chunk_id, data in enumerate(results):
            nbytes = getattr(data, "nbytes", None) or len(data)
            with span(log, "drain_chunk", chunk_id=chunk_id, bytes=nbytes):
                if prev is not None:
                    prev.result()
                prev = pool.submit(writer.write, data)
        if prev is not None:
            prev.result()
