"""Chunk-size planning.

Reproduces the reference's effective-chunk-size policy
(reference: blt_core/src/chunking.rs:18-62): a CLI-provided size is clamped to
[256KB, 128MB]; otherwise the size is derived from total RAM:
``clamp(RAM * memcap% / threads / 4, 1MB, 16MB)`` then re-clamped to the
absolute bounds. The same numbers are kept for CLI conformance; the device
planner below additionally aligns chunk sizes to static device shapes.
"""

from __future__ import annotations

from blt_tpu.utils import sysinfo

DEFAULT_MIN_CHUNK_SIZE_BYTES = 1024 * 1024  # 1MB
DEFAULT_MAX_CHUNK_SIZE_BYTES = 16 * 1024 * 1024  # 16MB
ABSOLUTE_MIN_CHUNK_SIZE = 256 * 1024  # 256KB
ABSOLUTE_MAX_CHUNK_SIZE = 128 * 1024 * 1024  # 128MB

# Device chunk buffers are padded to multiples of this, so the number of
# distinct static shapes (one compile each) stays small.
DEVICE_ALIGN = 1024


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(v, hi))


def get_effective_chunk_size(
    cli_chunk_size: int | None,
    num_threads: int,
    mem_cap_percent: int,
) -> int:
    """Effective host chunk size in bytes (chunking.rs:26-62 policy)."""
    if cli_chunk_size is not None:
        return _clamp(cli_chunk_size, ABSOLUTE_MIN_CHUNK_SIZE, ABSOLUTE_MAX_CHUNK_SIZE)

    total_ram = sysinfo.total_memory_bytes()
    usable = int(total_ram * (mem_cap_percent / 100.0))
    per_thread = usable // max(num_threads, 1)
    calculated = per_thread // 4
    return _clamp(
        _clamp(calculated, DEFAULT_MIN_CHUNK_SIZE_BYTES, DEFAULT_MAX_CHUNK_SIZE_BYTES),
        ABSOLUTE_MIN_CHUNK_SIZE,
        ABSOLUTE_MAX_CHUNK_SIZE,
    )


def mem_budget_bytes(mem_cap_percent: int) -> int:
    """The run's total host-memory byte budget: ``RAM * memcap%``.

    The same quantity the reference's chunk planner derives its sizes from
    (chunking.rs:33-42); used to bound every opportunistic host buffer
    (e.g. the AUTO engine's selection peek) that is not already covered by
    the chunk-size clamps.
    """
    return int(sysinfo.total_memory_bytes() * (mem_cap_percent / 100.0))


def align_up(n: int, align: int = DEVICE_ALIGN) -> int:
    return -(-n // align) * align


def plan_device_chunk(chunk_size: int) -> int:
    """Round a host chunk size up to an aligned static buffer size."""
    return align_up(max(chunk_size, DEVICE_ALIGN))
