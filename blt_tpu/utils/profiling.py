"""JAX profiler integration.

Analog of the reference's tracing/Criterion observability gap
(SURVEY.md 5: the reference's only profiling is RUST_LOG spans + Criterion;
the rebuild adds real device traces). Setting ``BLT_PROFILE=<dir>`` wraps
the tokenizer run in ``jax.profiler.trace`` so device kernels, transfers,
and host gaps show up in TensorBoard / xprof for any run — CLI, Python
API, or benchmarks — with zero overhead when unset.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

from blt_tpu.utils.logging import get_logger

log = get_logger("profiling")

ENV_VAR = "BLT_PROFILE"


@contextlib.contextmanager
def maybe_profile() -> Iterator[None]:
    """Wrap a run in a JAX profiler trace when BLT_PROFILE=<dir> is set."""
    outdir = os.environ.get(ENV_VAR)
    if not outdir:
        yield
        return
    import jax

    log.info("Writing JAX profiler trace to %s", outdir)
    with jax.profiler.trace(outdir):
        yield
