"""Build the native host library (libbltnative.<key>.so) with g++.

Usage: python -m blt_tpu.native.build
The library is optional: every consumer falls back to NumPy when it is
absent. No pybind11 — the ABI is plain C via ctypes.

The file name carries a key: a hash of the source, the compiler flags and
the machine type. A library built from another source, with other flags or
for another machine is never loaded; the one that matches is built from
``feeder.cpp`` on first use. The flags are portable (no ``-march=native``),
so a library built on one x86-64 host runs on any other.
"""

from __future__ import annotations

import glob
import hashlib
import logging
import os
import platform
import subprocess
import sys
import threading
import uuid

DIR = os.path.dirname(__file__)
SRC = os.path.join(DIR, "feeder.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_build_lock = threading.Lock()


def lib_path() -> str:
    """Path of the library for this source, these flags and this machine."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS + [platform.machine()]).encode())
    return os.path.join(DIR, f"libbltnative.{h.hexdigest()[:16]}.so")


def build(verbose: bool = True) -> str:
    out = lib_path()
    # Compile to a private temp name, then atomically rename: concurrent
    # builders (parallel pytest workers, racing threads in one process)
    # never see a half-written .so. The temp name carries pid + a random
    # suffix so two threads of one process cannot collide either.
    tmp = f"{out}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=not verbose)
        if proc.returncode != 0:
            tail = (proc.stderr or b"").decode("utf-8", "replace")[-2000:]
            raise RuntimeError(
                f"g++ failed to build {SRC}" + (f":\n{tail}" if tail else "")
            )
        os.replace(tmp, out)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    # libraries of other keys are stale: no run of this source loads them
    for old in glob.glob(os.path.join(DIR, "libbltnative*.so")):
        if old != out:
            try:
                os.unlink(old)
            except OSError:
                pass
    return out


def ensure_built() -> str | None:
    """Build the library if the one for the current key is missing.

    Returns the .so path, or None when building is impossible/disabled
    (BLT_NATIVE_BUILD=0, no g++, compile error) — callers fall back to
    NumPy. Mirrors the reference's always-compiled Rust core
    (reference: blt_core/src/io_handler.rs, pipeline.rs) without making
    the native engine a hard install-time dependency. Build failures are
    logged (not swallowed) so toolchain breakage is visible.
    """
    out = lib_path()
    if os.path.exists(out):
        return out
    if os.environ.get("BLT_NATIVE_BUILD", "1") == "0":
        return None
    with _build_lock:
        if os.path.exists(out):
            return out
        try:
            return build(verbose=False)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logging.getLogger("blt.native").warning(
                "native build failed; falling back to NumPy: %s", e
            )
            return None


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
