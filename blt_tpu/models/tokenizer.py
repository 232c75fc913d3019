"""The flagship "model": a jittable tokenizer forward step.

The reference has no neural models — its unit of computation is the
tokenization strategy (blt_core/src/tokenizer.rs). This module packages the
device encode step as a model-like object: static config (merge table on
device) + a pure jittable forward function, suitable for jit/sharding and
the compile check in __graft_entry__.entry().
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from blt_tpu.merges import MergeTable
from blt_tpu.ops import bpe_jax


class TokenizerModel:
    """Flat-BPE tokenizer as a forward step over fixed-size byte buffers."""

    def __init__(self, table: MergeTable):
        if not table.flat:
            raise ValueError("TokenizerModel requires a flat merge table")
        self.table = table
        self.dense = bpe_jax.dense_table_device(table)

    def forward(
        self,
        data: jnp.ndarray,  # uint8[N]
        length: jnp.ndarray,  # int32 scalar
        carry_in: jnp.ndarray,  # bool scalar
        next_byte: jnp.ndarray,  # int32 scalar
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(tokens[N], count, carry_out, be_bytes[2N]) — jittable."""
        return bpe_jax.flat_encode(data, length, self.dense, carry_in, next_byte)

    def example_args(self, n: int = 65536, seed: int = 0):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, n, dtype=np.uint8)
        return (
            jnp.asarray(data),
            jnp.int32(n),
            jnp.asarray(False),
            jnp.int32(-1),
        )
