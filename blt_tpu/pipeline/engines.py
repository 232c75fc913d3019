"""Tokenization engines: NumPy host engine and JAX device engine.

The device replacement for the reference's strategy objects
(reference: blt_core/src/tokenizer.rs trait TokenizationStrategy). An engine
consumes an ordered iterator of uint8 chunk arrays (each at most
``chunk_hint`` bytes) and yields ordered bytes-like results; ordering is
positional (array index = chunk id), which replaces the reference's
mpsc-channel reorder buffer (pipeline.rs:153-168).

JaxEngine pipelining: device dispatch is asynchronous, so up to ``depth``
batches are in flight; the BPE stitching carry stays ON DEVICE between
batches (a scalar dependency XLA pipelines), and the only host syncs are the
ordered result drains. The merges table is uploaded once per run — the
replicate-once analog of the reference's Arc<BpeMerges> (lib.rs:277).
"""

from __future__ import annotations

import collections
import os
from typing import Iterable, Iterator, Optional

import numpy as np

from blt_tpu.merges import MergeTable
from blt_tpu.ops import bpe_numpy
from blt_tpu.utils.chunking import align_up
from blt_tpu.utils.logging import get_logger

log = get_logger("engine")

# In-memory device payloads (server/API) bucket their padded size to powers
# of two: every device program is shape-specialized, so a long-lived process
# compiles O(log max-payload) programs instead of one per distinct payload
# size.
DEVICE_HINT_FLOOR = 1 << 16


def device_capacity_hint(size: int, engine) -> int:
    """Capacity hint for a single in-memory payload of ``size`` bytes.

    Device engines get the power-of-two bucket >= size; host engines keep
    the exact size (no shape-specialized compilation to amortize).
    """
    if size <= 0 or getattr(engine, "name", "") not in ("jax", "shard"):
        return size
    return max(DEVICE_HINT_FLOOR, 1 << (size - 1).bit_length())


def backend_platform() -> str:
    """JAX's default backend ("cpu", "gpu", ...): the one place the
    program asks which kind of device it runs on."""
    import jax

    return jax.default_backend()


class NumpyEngine:
    """Vectorized host engine (CPU path; also the small-input fast path).

    Uses the native C++ library (multithreaded widen / flat-BPE scan) when
    built, falling back to pure NumPy — the host-side stand-in for the
    reference's Tokio worker pool (pipeline.rs:86-100); ``threads`` carries
    the CLI --threads / num_cpus policy (utils.rs:79-97).
    """

    name = "numpy"

    def __init__(self, threads: int = 0):
        from blt_tpu import native

        self.threads = threads if threads > 0 else (os.cpu_count() or 1)
        self._native = native if native.available() else None

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        for chunk in chunks:
            if self._native is not None:
                yield self._native.widen_be(chunk, self.threads)
            else:
                yield chunk.astype(">u2")  # fresh array; writer takes the buffer

    def passthrough_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        for chunk in chunks:
            yield memoryview(np.ascontiguousarray(chunk)).cast("B")

    def bpe_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        if table.flat:
            yield from self._bpe_flat_stream(chunks, table)
        else:
            # General tables: independent per-chunk multipass, which is the
            # reference's own chunked behavior (BPE output then depends on
            # chunk size exactly as the reference's does, SURVEY.md 2.1.6).
            for chunk in chunks:
                toks = bpe_numpy.bpe_encode_multipass(chunk, table)
                yield toks.astype(">u2")

    def _bpe_flat_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable
    ) -> Iterator[bytes]:
        carry = False
        prev: Optional[np.ndarray] = None

        def encode(data: np.ndarray, carry_in: bool, next_byte: int):
            if self._native is not None:
                return self._native.flat_bpe(
                    data, table.dense, carry_in, next_byte, self.threads
                )
            toks, c = bpe_numpy.bpe_encode_flat_carry(
                data, table, carry_in, next_byte
            )
            return toks.astype(">u2"), c

        for chunk in chunks:
            if chunk.shape[0] == 0:
                continue
            if prev is not None:
                wire, carry = encode(prev, carry, int(chunk[0]))
                yield wire
            prev = chunk
        if prev is not None:
            wire, _ = encode(prev, carry, -1)
            yield wire


class JaxEngine:
    """Single-device engine: async pipelined batches, on-device carries."""

    name = "jax"

    def __init__(self, depth: int = 2, threads: int = 0):
        import jax  # lazy: keep CLI startup fast on the pure-host paths

        from blt_tpu.utils.compcache import enable_compilation_cache

        enable_compilation_cache()
        self._jax = jax
        dev = jax.devices()[0]
        log.info("Device engine %s on %d %s device(s) (%s)", self.name,
                 jax.device_count(), dev.platform, dev.device_kind)
        self.depth = depth
        # --threads policy for the host-side stages (batch fill); 0 = auto
        # (cpu count), matching NumpyEngine
        self.threads = threads if threads > 0 else (os.cpu_count() or 1)

    def _pad_to(self, chunk: np.ndarray, n: int) -> np.ndarray:
        if chunk.shape[0] == n:
            return np.ascontiguousarray(chunk)
        buf = np.zeros(n, dtype=np.uint8)
        buf[: chunk.shape[0]] = chunk
        return buf

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        from blt_tpu.ops import bpe_jax

        jnp = self._jax.numpy
        n_static = align_up(chunk_hint)
        pending = collections.deque()
        for chunk in chunks:
            length = chunk.shape[0]
            if length == 0:
                continue
            dev = jnp.asarray(self._pad_to(chunk, n_static))
            pending.append((bpe_jax.basic_encode(dev), length))
            if len(pending) > self.depth:
                yield self._drain_basic(pending)
        while pending:
            yield self._drain_basic(pending)

    def _drain_basic(self, pending) -> bytes:
        out, length = pending.popleft()
        # uint16 LE image == u16-BE wire stream; flatten host-side
        host = np.asarray(out).reshape(-1)
        return host[:length]  # u16 view; LE image == BE wire

    def passthrough_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        # Identity map: never round-trip through the device.
        for chunk in chunks:
            yield memoryview(np.ascontiguousarray(chunk)).cast("B")

    def bpe_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        if table.flat:
            yield from self._bpe_flat_stream(chunks, table, chunk_hint)
        else:
            yield from self._bpe_multipass_stream(chunks, table, chunk_hint)

    def _bpe_flat_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        from blt_tpu.ops import bpe_jax

        jnp = self._jax.numpy
        dense = bpe_jax.dense_table_device(table)
        n_static = align_up(chunk_hint)
        pending = collections.deque()
        carry = jnp.asarray(False)
        prev: Optional[np.ndarray] = None

        def dispatch(chunk: np.ndarray, next_byte: int):
            nonlocal carry
            dev = jnp.asarray(self._pad_to(chunk, n_static))
            _, count, carry_out, be = bpe_jax.flat_encode(
                dev,
                jnp.int32(chunk.shape[0]),
                dense,
                carry,
                jnp.int32(next_byte),
            )
            carry = carry_out
            pending.append((count, be))

        for chunk in chunks:
            if chunk.shape[0] == 0:
                continue
            if prev is not None:
                dispatch(prev, int(chunk[0]))
                if len(pending) > self.depth:
                    yield self._drain_bpe(pending)
            prev = chunk
        if prev is not None:
            dispatch(prev, -1)
        while pending:
            yield self._drain_bpe(pending)

    def _drain_bpe(self, pending) -> bytes:
        count, be = pending.popleft()
        n_tokens = int(count)
        host = np.asarray(be)  # uint16 LE image == u16-BE wire stream
        return host[:n_tokens]

    def _bpe_multipass_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        """General (non-flat) tables: the whole repeat-until-done loop runs
        on device (lax.while_loop + searchsorted lookup), one upload and one
        download per chunk. Per-chunk semantics (general tables match the
        reference's chunk-dependent output, SURVEY.md 2.1.6)."""
        from blt_tpu.ops import bpe_jax

        jnp = self._jax.numpy
        keys, vals = bpe_jax.sparse_table_device(table)
        n_static = align_up(chunk_hint)
        pending = collections.deque()
        for chunk in chunks:
            if chunk.shape[0] == 0:
                continue
            dev = jnp.asarray(self._pad_to(chunk, n_static))
            toks, count = bpe_jax.multipass_encode(
                dev, jnp.int32(chunk.shape[0]), keys, vals
            )
            be = bpe_jax.tokens_to_be_bytes_device(toks)
            pending.append((count, be))
            if len(pending) > self.depth:
                yield self._drain_bpe(pending)
        while pending:
            yield self._drain_bpe(pending)


class ShardedJaxEngine(JaxEngine):
    """Multi-device engine: row-sharded batches over a 1-D device mesh.

    The pipeline-level integration of parallel.sharded: each feed batch is
    laid out as (n_devices, row_bytes) rows sharded over the mesh's data
    axis, the merges table is replicated, cross-row AND cross-batch BPE
    stitching is exact via the carry-composition scan + threaded batch
    carry (the multi-device analog of the reference's in-order shard
    assembler, pipeline.rs:153-168). Non-flat tables keep the per-chunk
    reference semantics, one chunk per device.
    """

    name = "shard"

    def __init__(self, mesh=None, depth: int = 2, threads: int = 0):
        super().__init__(depth=depth, threads=threads)
        from blt_tpu.parallel.mesh import (
            make_mesh,
            replicated,
            row_sharding,
            vec_sharding,
        )

        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_rows = int(self.mesh.devices.size)
        self._row_sh = row_sharding(self.mesh)
        self._vec_sh = vec_sharding(self.mesh)
        self._rep_sh = replicated(self.mesh)
        self._layout_logged = False

    def _layout(self, chunk: np.ndarray, row_bytes: int):
        """Fill a (n_rows, row_bytes) batch front-to-back + per-row lengths.

        Rows are consecutive slices of the chunk, so the fill is ONE
        contiguous (native multithreaded) copy into an uninitialized
        buffer — no memset, no per-row Python loop; bytes beyond each
        row's length are stale and every consumer masks by the lengths
        vector (sharded_flat_encode's valid_pair/keep masks; the basic
        drain slices the contiguous valid prefix)."""
        from blt_tpu.pipeline.feeder import pack_into

        b = self.n_rows
        n = chunk.shape[0]
        # a chunk beyond the batch capacity would silently drop its tail
        assert n <= b * row_bytes, (n, b, row_bytes)
        batch = np.empty((b, row_bytes), np.uint8)
        pack_into(batch.reshape(-1), chunk, self.threads)
        full = n // row_bytes
        lengths = np.zeros(b, np.int32)
        lengths[:full] = row_bytes
        if full < b:
            lengths[full] = n - full * row_bytes
        batch_d = self._jax.device_put(batch, self._row_sh)
        if not self._layout_logged:
            self._layout_logged = True
            log.info("Sharded batch rows on %d devices: %s",
                     len(batch_d.sharding.device_set),
                     sorted(str(d) for d in batch_d.sharding.device_set))
        return (
            batch_d,
            self._jax.device_put(lengths, self._vec_sh),
            lengths,
        )

    def _row_bytes(self, chunk_hint: int) -> int:
        return align_up(-(-chunk_hint // self.n_rows))

    def basic_stream(
        self, chunks: Iterable[np.ndarray], chunk_hint: int
    ) -> Iterator[bytes]:
        from blt_tpu.parallel.sharded import sharded_basic_encode
        from blt_tpu.pipeline.feeder import prefetch_iter

        row_bytes = self._row_bytes(chunk_hint)

        def feed():
            for chunk in chunks:
                if chunk.shape[0] == 0:
                    continue
                batch_d, _, _ = self._layout(chunk, row_bytes)
                yield sharded_basic_encode(batch_d), chunk.shape[0]

        def drain(items):
            for out, n in items:
                # rows are filled front-to-back, so the valid tokens form a
                # CONTIGUOUS prefix of the flattened (b, row_bytes) u16
                # batch: one transfer, one slice, zero per-row joins (u16
                # LE image == u16-BE wire). Copy short tails so a view
                # does not pin the whole batch buffer (spool accounting).
                host = np.asarray(out).reshape(-1)
                if 2 * n < host.nbytes:
                    yield host[:n].copy()
                else:
                    yield host[:n]

        yield from prefetch_iter(
            drain(prefetch_iter(feed(), self.depth, "feed")),
            self.depth,
            "drain",
        )

    def _bpe_flat_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        from blt_tpu.parallel.sharded import sharded_flat_encode
        from blt_tpu.pipeline.feeder import prefetch_iter

        row_bytes = self._row_bytes(chunk_hint)
        dense_d = self._jax.device_put(table.dense, self._rep_sh)
        jnp = self._jax.numpy

        def feed():
            carry = jnp.asarray(False)  # device scalar after the first batch
            prev: Optional[np.ndarray] = None

            def dispatch(data: np.ndarray, next_byte: int):
                nonlocal carry
                batch_d, lengths_d, _ = self._layout(data, row_bytes)
                tokens, counts, carry = sharded_flat_encode(
                    batch_d, lengths_d, dense_d, carry, jnp.int32(next_byte)
                )
                return tokens, counts

            for chunk in chunks:
                if chunk.shape[0] == 0:
                    continue
                if prev is not None:
                    yield dispatch(prev, int(chunk[0]))
                prev = chunk
            if prev is not None:
                yield dispatch(prev, -1)

        def drain(items):
            for tokens_dev, counts_dev in items:
                yield self._join_rows(tokens_dev, counts_dev, self.n_rows)

        yield from prefetch_iter(
            drain(prefetch_iter(feed(), self.depth, "feed")),
            self.depth,
            "drain",
        )

    @staticmethod
    def _join_rows(tokens_dev, counts_dev, nrows: int) -> np.ndarray:
        """Concatenate each row's first ``counts[r]`` tokens as u16-BE:
        single-allocation assembly (empty rows have count 0)."""
        tokens_h = np.asarray(tokens_dev)
        counts_h = np.asarray(counts_dev)
        out = np.empty(int(counts_h[:nrows].sum()), dtype=">u2")
        o = 0
        for r in range(nrows):
            c = int(counts_h[r])
            if c:
                out[o : o + c] = tokens_h[r, :c]
                o += c
        return out

    def _bpe_multipass_stream(
        self, chunks: Iterable[np.ndarray], table: MergeTable, chunk_hint: int
    ) -> Iterator[bytes]:
        """General (hierarchical) tables, row-parallel over the mesh.

        Chunks are independent in this mode (the reference's own per-chunk
        semantics, SURVEY.md 2.1.6), so groups of n_devices chunks run as
        one row-sharded, vmapped multipass — every mode uses every device.
        """
        from blt_tpu.ops import bpe_jax

        jax = self._jax
        keys, vals = bpe_jax.sparse_table_device(table)
        keys = jax.device_put(keys, self._rep_sh)
        vals = jax.device_put(vals, self._rep_sh)
        n_static = align_up(chunk_hint)
        b = self.n_rows
        group: list = []
        pending = collections.deque()

        def flush():
            if not group:
                return
            batch = np.zeros((b, n_static), np.uint8)
            lengths = np.zeros(b, np.int32)
            for r, chunk in enumerate(group):
                batch[r, : chunk.shape[0]] = chunk
                lengths[r] = chunk.shape[0]
            toks, counts = bpe_jax.multipass_encode_rows(
                jax.device_put(batch, self._row_sh),
                jax.device_put(lengths, self._vec_sh),
                keys,
                vals,
            )
            pending.append((toks, counts, len(group)))
            group.clear()

        def drain() -> bytes:
            return self._join_rows(*pending.popleft())

        for chunk in chunks:
            if chunk.shape[0] == 0:
                continue
            group.append(chunk)
            if len(group) == b:
                flush()
                if len(pending) > self.depth:
                    yield drain()
        flush()
        while pending:
            yield drain()


AUTO_DEVICE_THRESHOLD = 32 * 1024 * 1024


def _probe_device_engine():
    """The device engine for this process, or None (no accelerator).

    Once JAX reports an accelerator backend, a failure to build the device
    engine raises: it must never hide behind a silent host run.
    """
    platform = backend_platform()
    if platform == "cpu":
        return None
    import jax

    # every device of a multi-device host by default
    engine = ShardedJaxEngine() if jax.device_count() > 1 else JaxEngine()
    log.info("AUTO device probe: %s backend, %d device(s) -> %s engine",
             platform, jax.device_count(), engine.name)
    return engine


class AutoStreamEngine:
    """AUTO engine for unknown-size inputs (stdin): peek, then commit.

    Selection is deferred until the first chunks arrive: the stream is
    buffered until EOF or the peek threshold of accumulated bytes, then
    the whole stream (buffered prefix + remainder) is replayed through the
    chosen engine — small pipes stay on the NumPy engine (device dispatch
    latency dominates), large pipes tokenize on the accelerator. Because no
    engine consumes a byte before selection, semantics are identical either
    way. The peek buffer honors the run's --memcap budget: the threshold is
    ``min(AUTO_DEVICE_THRESHOLD, mem_budget)``, so a small memory cap never
    gets blown by the selection peek itself. Deliberate consequence: when
    the budget is below the 32MB dispatch-latency threshold, reaching the
    budget commits to the accelerator — the stream is at least as large
    as we were allowed to look at, and the failure mode of keeping a
    many-GB pipe on the host engine outweighs a possibly-early device
    pick for a stream in the budget..32MB range.
    """

    name = "auto"

    def __init__(self, threads: int = 0, mem_budget: Optional[int] = None):
        self.threads = threads
        self.selected = None  # set on first stream; exposed for tests/logs
        self.peek_threshold = AUTO_DEVICE_THRESHOLD
        if mem_budget is not None and mem_budget > 0:
            self.peek_threshold = min(AUTO_DEVICE_THRESHOLD, mem_budget)

    def _select(self, chunks: Iterable[np.ndarray]):
        import itertools

        buffered = []
        total = 0
        it = iter(chunks)
        for chunk in it:
            buffered.append(chunk)
            total += chunk.shape[0]
            if total >= self.peek_threshold:
                break
        engine = None
        if total >= self.peek_threshold:
            engine = _probe_device_engine()
        if engine is None:
            engine = NumpyEngine(self.threads)
        self.selected = engine
        log.info("AUTO stream committed to %s engine (%d bytes peeked)",
                 engine.name, total)
        return engine, itertools.chain(buffered, it)

    def basic_stream(self, chunks, chunk_hint: int) -> Iterator[bytes]:
        engine, replay = self._select(chunks)
        yield from engine.basic_stream(replay, chunk_hint)

    def passthrough_stream(self, chunks, chunk_hint: int) -> Iterator[bytes]:
        # identity copy never benefits from the device
        engine = NumpyEngine(self.threads)
        self.selected = engine
        yield from engine.passthrough_stream(chunks, chunk_hint)

    def bpe_stream(self, chunks, table: MergeTable, chunk_hint: int) -> Iterator[bytes]:
        engine, replay = self._select(chunks)
        yield from engine.bpe_stream(replay, table, chunk_hint)


class PayloadAutoEngine:
    """Per-payload engine selection for known-size in-memory requests.

    The serving twin of the CLI's AUTO policy: each request's size is
    known up front (Content-Length), so selection is a simple threshold —
    small payloads stay on the host engine (device dispatch latency
    dominates), large payloads go to the accelerator when one exists.
    The device engine is probed lazily ONCE (first large payload) and
    shared across requests; callers resolve the concrete engine with
    ``select(size)`` before streaming.
    """

    name = "auto"

    def __init__(
        self, threads: int = 0, device_threshold: Optional[int] = None
    ):
        import threading

        self.threads = threads
        self.threshold = (
            device_threshold
            if device_threshold and device_threshold > 0
            else AUTO_DEVICE_THRESHOLD
        )
        self._host = NumpyEngine(threads)
        self._device = None
        self._probed = False
        # serialize the first probe: under ThreadingHTTPServer, two
        # concurrent large requests must not double-probe (duplicate
        # device init) or race check-then-act into silently serving a
        # large payload on the host engine
        self._probe_lock = threading.Lock()

    def select(self, size: int):
        if size >= self.threshold:
            if not self._probed:
                with self._probe_lock:
                    if not self._probed:
                        self._device = _probe_device_engine()
                        self._probed = True
                        if self._device is not None:
                            log.info(
                                "payload AUTO: %s engine for payloads "
                                ">= %d bytes",
                                self._device.name, self.threshold,
                            )
            if self._device is not None:
                return self._device
        return self._host


def select_engine(
    engine_pref,
    input_size: Optional[int],
    threads: int = 0,
    mem_budget: Optional[int] = None,
):
    """AUTO: device engine for large inputs on an accelerator, else NumPy.

    Device dispatch + compile latency dominates small inputs; the NumPy
    engine is already at memory-bandwidth speed there. Unknown-size streams
    get the peek-then-commit AutoStreamEngine, whose peek buffer is bounded
    by ``mem_budget`` (the --memcap-derived byte budget) when given.
    """
    from blt_tpu.config import Engine

    if engine_pref == Engine.NUMPY:
        return NumpyEngine(threads)
    if engine_pref == Engine.JAX:
        return JaxEngine(threads=threads)
    if engine_pref == Engine.SHARD:
        return ShardedJaxEngine(threads=threads)
    if input_size is None:
        return AutoStreamEngine(threads, mem_budget=mem_budget)
    if input_size < AUTO_DEVICE_THRESHOLD:
        return NumpyEngine(threads)
    engine = _probe_device_engine()
    return engine if engine is not None else NumpyEngine(threads)
