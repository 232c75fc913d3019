"""Multi-host (multi-process) tokenization runner.

The reference is single-node (SURVEY.md 2: no distributed backend); the
BASELINE.json north star defines the multi-host shape: corpus byte-ranges
sharded across hosts, merges replicated, outputs assembled host-in-order.

Design — communication is replaced by boundary *analysis*:

- **flat BPE**: a host boundary placed at position j where the straddling
  pair (b[j-1], b[j]) is NOT a merge rule is provably transparent — no
  merge can consume byte j (match bits are parity-independent), so the
  carry into the range is 0 and the parity scan restarts exactly as the
  global stream would. Each host's range therefore encodes as an
  independent stream, bit-equal to its slice of the single-host output,
  with ZERO cross-host traffic during encoding. ``safe_split_bounds``
  nudges each nominal boundary forward to the nearest such position
  (vectorized mmap scan; typically a few bytes).
- **non-flat BPE** keeps the reference's per-chunk semantics, so host
  boundaries align to the GLOBAL chunk grid (multiples of the effective
  chunk size from byte 0): every chunk lands on exactly one host and the
  concatenated output equals the single-host run.
- **basic / passthrough** split anywhere; output offsets are affine in
  the input offset (2x / 1x), so hosts write directly at their offset.

Output assembly (the promise of parallel/distributed.py's docstring):
hosts with size-deterministic output pwrite in place; BPE hosts spool
in MEMORY up to half the memcap'd RAM (disk beyond — _Spool), all-gather
per-host token counts (one tiny collective — the only communication in
the whole run), then pwrite the spool at ``header + sum(counts[:h])``,
so within budget every output byte crosses the filesystem exactly once.

Launch: same CLI on every host with BLT_COORDINATOR_ADDRESS,
BLT_NUM_PROCESSES, BLT_PROCESS_ID set, e.g.

    BLT_COORDINATOR_ADDRESS=host0:9876 BLT_NUM_PROCESSES=2 \
    BLT_PROCESS_ID=$RANK blt -i corpus.bin -o out.bin --merges m.txt
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

from blt_tpu.config import CoreConfig, Mode
from blt_tpu.merges import NO_RULE
from blt_tpu.utils.chunking import get_effective_chunk_size
from blt_tpu.utils.logging import get_logger

log = get_logger("multihost")

# bytes scanned per window while searching for a safe split
_SCAN_WINDOW = 4 * 1024 * 1024


def env_distributed() -> bool:
    """True when the BLT multi-process env contract is set."""
    return os.environ.get("BLT_COORDINATOR_ADDRESS") is not None


def initialize_from_env() -> None:
    from blt_tpu.parallel import distributed as dist

    missing = [
        v
        for v in ("BLT_NUM_PROCESSES", "BLT_PROCESS_ID")
        if v not in os.environ
    ]
    if missing:
        raise ValueError(
            "incomplete multi-process environment: BLT_COORDINATOR_ADDRESS "
            f"is set but {', '.join(missing)} is missing (the contract needs "
            "all three; see docs/DEPLOYMENT.md)"
        )
    dist.initialize(
        coordinator_address=os.environ["BLT_COORDINATOR_ADDRESS"],
        num_processes=int(os.environ["BLT_NUM_PROCESSES"]),
        process_id=int(os.environ["BLT_PROCESS_ID"]),
    )


def even_bounds(total: int, n: int) -> List[int]:
    """n+1 monotone bounds of near-equal contiguous ranges."""
    per = -(-total // n) if total else 0
    return [min(i * per, total) for i in range(n)] + [total]


def chunk_aligned_bounds(total: int, chunk: int, n: int) -> List[int]:
    """Host bounds snapped DOWN to the global chunk grid (non-flat BPE:
    every size-``chunk`` chunk from byte 0 lands wholly on one host)."""
    raw = even_bounds(total, n)
    snapped = [0]
    for b in raw[1:-1]:
        snapped.append(max(snapped[-1], (b // chunk) * chunk))
    snapped.append(total)
    return snapped


def safe_split_bounds(
    mm: np.ndarray, dense: np.ndarray, n: int
) -> List[int]:
    """Flat-BPE host bounds, each nudged to a merge-transparent position.

    A split at j is safe iff the pair (mm[j-1], mm[j]) is not a rule
    (dense[pair] == NO_RULE): no merge can straddle it, under either
    parity. Deterministic pure function of (mm, dense, n) — every host
    computes identical bounds with no communication. If a window holds no
    safe position the scan widens; a pathological all-matches file
    degrades to fewer effective hosts (correctness first).
    """
    total = mm.shape[0]
    nominal = even_bounds(total, n)
    bounds = [0]
    for b in nominal[1:-1]:
        j = max(b, bounds[-1])
        found: Optional[int] = None
        while j < total:
            hi = min(j + _SCAN_WINDOW, total)
            if j >= 1 and hi > j:
                window = mm[j - 1 : hi]
                pairs = window[:-1].astype(np.int32) * 256 + window[1:]
                ok = np.nonzero(dense[pairs] == NO_RULE)[0]
                if ok.size:
                    found = j + int(ok[0])
                    break
            elif j == 0:
                found = 0
                break
            j = hi
        bounds.append(total if found is None else found)
    bounds.append(total)
    return bounds


# Multi-process default chunk when no CLI size is given: the auto
# planner's upper clamp (chunking.rs policy cap). The single-host auto
# planner derives the chunk from LOCAL total RAM, which on heterogeneous
# hosts would give each process a DIFFERENT global chunk grid — and
# non-flat BPE bounds and output depend on that grid, so every host must
# pin the same value with no communication.
DIST_DEFAULT_CHUNK = 16 * 1024 * 1024


def dist_chunk_size(config: CoreConfig) -> int:
    """Host-RAM-independent effective chunk size for multi-process runs."""
    if config.cli_chunk_size is not None:
        return get_effective_chunk_size(
            config.cli_chunk_size, config.num_threads, config.mem_cap_percent
        )
    return DIST_DEFAULT_CHUNK


def plan_bounds(config: CoreConfig, total: int, mm, nproc: int) -> List[int]:
    mode = config.mode
    if mode == Mode.BPE:
        table = config.table()
        if table.flat:
            return safe_split_bounds(mm, table.dense, nproc)
        return chunk_aligned_bounds(total, dist_chunk_size(config), nproc)
    return even_bounds(total, nproc)


def _allgather_counts(local_count: int) -> np.ndarray:
    """Per-process output byte counts, host-order (the one collective)."""
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(np.int64(local_count))
    ).reshape(-1)


class _Spool:
    """Output spool for offset-unknown assembly: memory first, disk beyond.

    BPE/decode hosts cannot know their output offset until the per-host
    counts are all-gathered, so results accumulate until then. Up to
    ``budget`` bytes they are held as buffer references (the engines
    yield fresh buffers per item) and each output byte crosses the
    filesystem ONCE at pwrite time; past the budget everything spills to
    a temp file next to the output (the r3 behavior) and only the spilled
    bytes are written twice. Budget derives from the --memcap contract
    (half the capped RAM, the other half stays with the engine pipeline).
    """

    def __init__(self, out_dir: str, budget: int):
        self.budget = budget
        self.out_dir = out_dir
        self.parts: list = []
        self.bytes = 0
        self.path: Optional[str] = None
        self._file = None

    def write(self, data) -> int:
        nb = getattr(data, "nbytes", None) or len(data)
        if self._file is None and self.bytes + nb > self.budget:
            self._spill()
        if self._file is not None:
            self._file.write(data)
        else:
            self.parts.append(data)
        self.bytes += nb
        return nb

    def _spill(self) -> None:
        f = tempfile.NamedTemporaryFile(
            dir=self.out_dir, prefix=".blt_spool_", delete=False
        )
        self.path = f.name
        self._file = f
        log.info(
            "spool exceeding %d-byte memory budget; spilling to %s",
            self.budget, self.path,
        )
        for part in self.parts:
            f.write(part)
        self.parts.clear()

    def drain_to(self, fd: int, off: int) -> int:
        """pwrite all spooled bytes at ``off``; returns bytes written."""
        written = 0
        if self._file is not None:
            self._file.flush()
            with open(self.path, "rb") as sp:
                while True:
                    buf = sp.read(1 << 22)
                    if not buf:
                        break
                    written += _pwrite_all(fd, buf, off + written)
        for part in self.parts:
            written += _pwrite_all(fd, part, off + written)
        return written

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        if self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self.parts.clear()


def _spool_budget(config: CoreConfig) -> int:
    """Memory the spool may hold before spilling: half the memcap'd RAM."""
    from blt_tpu.utils.sysinfo import total_memory_bytes

    ram = total_memory_bytes()
    return max(64 << 20, int(ram * config.mem_cap_percent / 100) // 2)


def _pwrite_all(fd: int, buf, off: int) -> int:
    """pwrite the WHOLE buffer at off (a short kernel write would silently
    shift every following byte of this host's region); returns bytes written."""
    view = memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    written = 0
    while written < len(view):
        n = os.pwrite(fd, view[written:], off + written)
        if n == 0:
            raise OSError(f"pwrite wrote 0 of {len(view) - written} bytes")
        written += n
    return written


def _run_decode_distributed(
    config: CoreConfig, mm, total: int, pid: int, nproc: int
) -> None:
    """Multi-process decode: token-aligned even split, spooled assembly.

    Decode is token-independent (each id expands in isolation,
    ops/decode.py), so any even-offset boundary after the verified header
    is transparent; every host verifies the header (cheap, and keeps the
    error surface identical on all ranks), decodes its token range, and
    places its bytes at the all-gathered offset exactly like the BPE
    encode path.
    """
    import jax  # noqa: F401  (jax.distributed already initialized)

    from blt_tpu.ops.decode import (
        build_expansion_table,
        decode_wire,
        header_mismatch_error,
        missing_header_error,
        odd_trailing_error,
    )

    base = 0
    if config.content_type is not None:
        if total < 2:
            raise missing_header_error()
        tok = (int(mm[0]) << 8) | int(mm[1])
        if tok != config.content_type.token_value:
            raise header_mismatch_error(config.content_type, tok)
        base = 2
    if (total - base) % 2:
        raise odd_trailing_error()
    n_tokens = (total - base) // 2
    tok_bounds = even_bounds(n_tokens, nproc)
    lo = base + 2 * tok_bounds[pid]
    hi = base + 2 * tok_bounds[pid + 1]
    log.info("host %d/%d: tokens [%d, %d) of %d", pid, nproc,
             tok_bounds[pid], tok_bounds[pid + 1], n_tokens)

    table = build_expansion_table(config.bpe_data)
    feed = max(dist_chunk_size(config) & ~1, 2)

    fd = os.open(config.output, os.O_WRONLY | os.O_CREAT, 0o644)
    spool = _Spool(
        os.path.dirname(os.path.abspath(config.output)) or ".",
        _spool_budget(config),
    )
    try:
        local_count = 0
        for start in range(lo, hi, feed):
            out = decode_wire(
                mm[start : min(start + feed, hi)], table,
                config.num_threads,
            )
            local_count += spool.write(out)
        counts = (
            _allgather_counts(local_count)
            if nproc > 1
            else np.array([local_count], np.int64)
        )
        spool.drain_to(fd, int(counts[:pid].sum()))
        if pid == 0:
            os.ftruncate(fd, int(counts.sum()))
    finally:
        # a decode failure mid-spool must not leak the temp file
        # (the shared output is left to the surviving ranks)
        spool.close()
        os.close(fd)

    if nproc > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("blt_decode_assembled")
    log.info("host %d/%d: wrote %d bytes", pid, nproc, local_count)


def run_tokenizer_distributed(config: CoreConfig) -> None:
    """Execute one multi-process tokenization run (file -> shared file).

    Every process runs this same function; each encodes its own byte
    range with its normal local engine and writes at its exact offset in
    the shared output. The result is byte-identical to a single-process
    run of the same config.
    """
    import jax

    from blt_tpu.pipeline.engines import select_engine
    from blt_tpu.pipeline.runner import _device_batch_bytes, _plan_feed_size

    if config.input is None or str(config.input) == "-":
        raise ValueError("multi-host runs require a file input (stdin is per-host)")
    if config.output is None or str(config.output) == "-":
        raise ValueError("multi-host runs require a file output")

    pid = jax.process_index()
    nproc = jax.process_count()
    total = os.path.getsize(config.input)
    mm = (
        np.memmap(config.input, dtype=np.uint8, mode="r")
        if total
        else np.empty(0, np.uint8)
    )

    mode = config.mode
    if mode == Mode.DECODE:
        _run_decode_distributed(config, mm, total, pid, nproc)
        return

    bounds = plan_bounds(config, total, mm, nproc)
    lo, hi = bounds[pid], bounds[pid + 1]
    log.info("host %d/%d: bytes [%d, %d) of %d", pid, nproc, lo, hi, total)

    header = b""
    if config.content_type is not None:
        header = config.content_type.token_value.to_bytes(2, "big")

    # the same host-RAM-independent chunk the bounds were planned with:
    # non-flat BPE output depends on the chunk grid itself, so the feed
    # must follow it exactly for byte-identical cross-host assembly
    effective_chunk_size = dist_chunk_size(config)
    engine = select_engine(config.engine, hi - lo, config.num_threads)
    invariant = mode in (Mode.BASIC, Mode.PASSTHROUGH) or (
        mode == Mode.BPE and config.table().flat
    )
    feed_size = effective_chunk_size
    if invariant and engine.name in ("jax", "shard"):
        # equalized batches over this host's byte range (zero padded-
        # capacity transfers; see runner._plan_feed_size)
        feed_size = _plan_feed_size(
            hi - lo, effective_chunk_size, _device_batch_bytes()
        )

    def chunks():
        for start in range(lo, hi, feed_size):
            yield mm[start : min(start + feed_size, hi)]

    if mode == Mode.PASSTHROUGH:
        results = engine.passthrough_stream(chunks(), feed_size)
    elif mode == Mode.BASIC:
        results = engine.basic_stream(chunks(), feed_size)
    else:
        results = engine.bpe_stream(chunks(), config.table(), feed_size)

    fd = os.open(config.output, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if mode in (Mode.BASIC, Mode.PASSTHROUGH):
            # size-deterministic: write directly at the known offset
            factor = 2 if mode == Mode.BASIC else 1
            off = len(header) + factor * lo
            for data in results:
                off += _pwrite_all(fd, data, off)
            local_count = off - (len(header) + factor * lo)
            assert local_count == factor * (hi - lo), (local_count, lo, hi)
            # no collective needed: offsets are affine in the input offset
            # (the end-of-run sync below is the only barrier)
            total_out = len(header) + factor * total
        else:
            # BPE: spool (memory-first), then place at the all-gathered
            # offset — within budget every output byte hits the disk once
            spool = _Spool(
                os.path.dirname(os.path.abspath(config.output)) or ".",
                _spool_budget(config),
            )
            try:
                local_count = 0
                for data in results:
                    local_count += spool.write(data)
                counts = (
                    _allgather_counts(local_count)
                    if nproc > 1
                    else np.array([local_count], np.int64)
                )
                off = len(header) + int(counts[:pid].sum())
                spool.drain_to(fd, off)
                total_out = len(header) + int(counts.sum())
            finally:
                # an encode failure mid-spool must not leak the temp file
                spool.close()
        if pid == 0:
            if header:
                os.pwrite(fd, header, 0)
            os.ftruncate(fd, total_out)
    finally:
        os.close(fd)

    if nproc > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("blt_output_assembled")
    log.info("host %d/%d: wrote %d bytes", pid, nproc, local_count)
