"""Multi-host initialization and corpus sharding.

The reference is strictly single-node (SURVEY.md 2: no distributed
backend). The BASELINE.json north star defines the multi-host shape:
``jax.distributed`` over a pod slice, corpus chunks sharded data-parallel
across hosts, merges table replicated, boundary state and per-pair counts
over collectives (NCCL between GPUs).

Launch on each host:

    import blt_tpu.parallel.distributed as dist
    dist.initialize()                      # jax.distributed.initialize()
    mesh = dist.global_mesh()              # 1-D data mesh over all chips
    lo, hi = dist.host_byte_range(total)   # this host's corpus slice

Each host feeds only its byte range. The full multi-process runner —
merge-transparent boundary planning, per-host encoding, and host-order
output assembly (pwrite at offset prefix(h) after a tiny all-gather of
per-host counts) — lives in blt_tpu/parallel/multihost.py and is wired
into the pipeline runner via the BLT_COORDINATOR_ADDRESS /
BLT_NUM_PROCESSES / BLT_PROCESS_ID environment contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

from blt_tpu.parallel.mesh import make_mesh
from blt_tpu.utils.logging import get_logger

log = get_logger("distributed")

# None = never attempted, "solo" = argless auto-bootstrap fell back to
# single-process, "real" = jax.distributed actually initialized. A later
# EXPLICIT (coordinator-address) call must still run after a solo
# fallback — treating the fallback as terminal would silently degrade an
# explicit multi-process launch to N independent solo runs.
_init_state: Optional[str] = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with idempotence and solo fallback.

    With no arguments, relies on the cluster environment JAX detects
    itself (e.g. SLURM). Single-process environments are a no-op, so code written for multi-host runs unchanged on one host.
    With an EXPLICIT coordinator address (the BLT_COORDINATOR_ADDRESS
    contract), failures re-raise — silently degrading an explicit
    multi-process launch to N independent solo runs would corrupt the
    shared output.
    """
    global _init_state
    if _init_state == "real":
        return
    if _init_state == "solo" and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _init_state = "real"
        log.info(
            "distributed initialized: process %d/%d",
            jax.process_index(),
            jax.process_count(),
        )
    except (ValueError, RuntimeError) as e:
        if coordinator_address is not None:
            raise
        # already initialized, or single-process without coordinator info
        log.debug("distributed init skipped: %s", e)
        _init_state = "solo"


def global_mesh():
    """1-D data-parallel mesh over every chip in the slice."""
    return make_mesh(jax.devices())


def host_byte_range(total_bytes: int) -> Tuple[int, int]:
    """This host's NAIVE contiguous corpus slice (even split).

    Thin wrapper over ``multihost.even_bounds`` for size-deterministic
    modes (basic/passthrough/decode). BPE runs must NOT split here —
    ``multihost.plan_bounds`` owns the merge-transparent / chunk-aligned
    planning the real runner uses.
    """
    from blt_tpu.parallel.multihost import even_bounds

    p = jax.process_index()
    bounds = even_bounds(total_bytes, jax.process_count())
    return bounds[p], bounds[p + 1]
