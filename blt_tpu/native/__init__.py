"""Native host engine bindings (ctypes over libbltnative.<key>.so, build.py).

The device does the tokenization math; this library keeps the host side
(basic-mode widening, passthrough copies, and the host engine's BPE scan)
at multithreaded memory bandwidth — the stand-in for the reference's
Rust+Tokio pipeline (reference: blt_core/src/pipeline.rs, io_handler.rs).
The library self-builds on first load when g++ is available (disable
with BLT_NATIVE_BUILD=0); callers fall back to NumPy when it cannot be
built (python -m blt_tpu.native.build builds it explicitly).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """Load (or return cached) native library; None if unavailable.

    ensure_built() runs unconditionally (its fresh-path cost is one hash of
    the source) so a library built from another source or with other flags
    is rebuilt rather than silently loaded.
    """
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    from blt_tpu.native.build import ensure_built

    lib_path = ensure_built()
    if lib_path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(lib_path)
        lib.blt_widen_be.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blt_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blt_flat_bpe.restype = ctypes.c_size_t
        lib.blt_flat_bpe.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_size_t,  # n
            ctypes.c_void_p,  # dense table
            ctypes.c_void_p,  # out
            ctypes.c_int,  # carry_in
            ctypes.c_int32,  # next_byte
            ctypes.POINTER(ctypes.c_int),  # carry_out
            ctypes.c_int,  # threads
        ]
        lib.blt_decode_size.restype = ctypes.c_int64
        lib.blt_decode_size.argtypes = [
            ctypes.c_void_p,  # wire
            ctypes.c_size_t,  # n_tokens
            ctypes.c_void_p,  # lengths
            ctypes.c_int,  # threads
        ]
        lib.blt_decode_fill.argtypes = [
            ctypes.c_void_p,  # wire
            ctypes.c_size_t,  # n_tokens
            ctypes.c_void_p,  # offsets
            ctypes.c_void_p,  # lengths
            ctypes.c_void_p,  # blob
            ctypes.c_void_p,  # out
            ctypes.c_int,  # threads
        ]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def copy_into(src: np.ndarray, dst: np.ndarray, threads: int) -> None:
    """Multithreaded copy of src into dst[:len(src)] (feeder buffer fill)."""
    lib = load()
    assert lib is not None
    assert dst.shape[0] >= src.shape[0]
    src = np.ascontiguousarray(src)
    lib.blt_copy(src.ctypes.data, dst.ctypes.data, src.shape[0], threads)


def widen_be(src: np.ndarray, threads: int) -> memoryview:
    """Basic mode byte->u16-BE at multithreaded memcpy speed.

    Returns a memoryview over a fresh buffer (no tobytes copy: the writer
    consumes the buffer protocol directly; on low-bandwidth hosts the
    extra 2n-byte copy would rival the widen itself).
    """
    lib = load()
    assert lib is not None
    src = np.ascontiguousarray(src)
    out = np.empty(2 * src.shape[0], np.uint8)
    lib.blt_widen_be(
        src.ctypes.data, out.ctypes.data, src.shape[0], threads
    )
    return memoryview(out)


def flat_bpe(
    src: np.ndarray,
    dense: np.ndarray,
    carry_in: bool,
    next_byte: int,
    threads: int,
) -> Tuple[bytes, bool]:
    """Single-pass flat BPE -> u16-BE bytes, with cross-chunk carries."""
    lib = load()
    assert lib is not None
    src = np.ascontiguousarray(src)
    out = np.empty(2 * max(src.shape[0], 1), np.uint8)
    carry_out = ctypes.c_int(0)
    count = lib.blt_flat_bpe(
        src.ctypes.data,
        src.shape[0],
        np.ascontiguousarray(dense).ctypes.data,
        out.ctypes.data,
        1 if carry_in else 0,
        next_byte,
        ctypes.byref(carry_out),
        threads,
    )
    return memoryview(out)[: 2 * count], bool(carry_out.value)


def decode_expand(
    wire: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    blob: np.ndarray,
    threads: int = 0,
):
    """Detokenize a u16-BE wire array via the native two-phase expand.

    Returns the decoded uint8 array, or an int — the position of the first
    invalid token (caller raises DecodeError with it).
    """
    lib = load()
    assert lib is not None
    wire = np.ascontiguousarray(wire)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    n_tokens = wire.shape[0] // 2
    if threads <= 0:
        threads = os.cpu_count() or 1
    total = lib.blt_decode_size(
        wire.ctypes.data, n_tokens, lengths.ctypes.data, threads
    )
    if total < 0:
        return int(-total - 1)
    out = np.empty(int(total), np.uint8)
    lib.blt_decode_fill(
        wire.ctypes.data, n_tokens, offsets.ctypes.data, lengths.ctypes.data,
        blob.ctypes.data, out.ctypes.data, threads,
    )
    return out
