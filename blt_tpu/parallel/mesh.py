"""Device mesh construction for data-parallel tokenization.

The reference's only parallelism is chunk-level data parallelism over a
thread pool (reference: blt_core/src/pipeline.rs:86-100). The device
equivalent is a 1-D ``jax.sharding.Mesh`` with a ``data`` axis: corpus
chunks are sharded row-wise across devices, the merges table is replicated
(the Arc<BpeMerges> analog, lib.rs:277), and cross-chunk boundary state
plus global statistics move over device collectives (psum / tiny gathers).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.array(devices), (DATA_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """(B, N) batches sharded by row across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def vec_sharding(mesh: Mesh) -> NamedSharding:
    """(B,) per-row scalars sharded across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))
