"""Persistent XLA compilation cache.

Caching compiled executables on disk lets every process after the first
skip the compile of each device program. Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and this module sets no directory; otherwise
the cache lives at a fixed path inside the checkout, ``<repo>/.jax_cache/``
(a fixed path, because the directory is part of the cache's key).
Enabled by every device-engine entry point.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_compilation_cache() -> None:
    global _enabled
    if _enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
