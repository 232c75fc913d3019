"""Sharded (multi-device) tokenization steps.

Corpus chunks are laid out as rows of a (B, N) batch sharded row-wise over
the mesh's ``data`` axis; the merges table is replicated. Cross-row BPE
stitching — the reference's in-order shard assembler analog
(blt_core/src/pipeline.rs:153-168) — becomes a tiny carry-composition scan:

1. every row computes its match bits / scans locally (no communication);
2. each row also computes its boundary carry-out for BOTH possible
   carry-in values, giving a boolean transfer function per row;
3. an associative scan composes the B transfer functions (XLA moves only
   2 bits per row over the device interconnect), resolving every row's true carry-in;
4. rows finish start-resolution + compaction locally.

This is exact: chained output equals the single-sequence reference result
for every flat (file-loadable) table, independent of B, N, or mesh size.

``pair_count_hist`` is the per-pair count reduction of BASELINE.json: a
row-local scatter-add histogram followed by a global psum over the data
axis (XLA inserts the collective from the sharding annotation).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from blt_tpu.merges import NO_RULE

# Plain int (not a device array): module import must never touch a backend.
_NEG_INF32 = -(2**31) + 1


def _row_phase1(row: jnp.ndarray, length: jnp.ndarray, next_byte: jnp.ndarray,
                dense: jnp.ndarray):
    """Per-row: match bits, pair values, last-nonmatch scan, carry pair."""
    n = row.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    t = row.astype(jnp.int32)
    nxt = jnp.roll(t, -1)
    last_i = jnp.maximum(length - 1, 0)
    nxt = nxt.at[last_i].set(jnp.where(next_byte >= 0, next_byte, 0))
    valid_pair = (idx < (length - 1)) | ((idx == length - 1) & (next_byte >= 0))
    pair_idx = t * 256 + nxt
    pv = jnp.take(dense, pair_idx)
    match = valid_pair & (pv != NO_RULE)
    lnm = jax.lax.cummax(jnp.where(match, _NEG_INF32, idx))
    # carry-out as a function of carry-in: evaluate the final-position start
    # bit under both initial-run parities.
    def carry_out(carry_in):
        lz = jnp.maximum(lnm, jnp.int32(-1) - carry_in)
        s_last = match[last_i] & (((last_i - lz[last_i]) & 1) == 1)
        # empty rows are identity transfers: a pending consumed-byte flag
        # passes through them to the next non-empty row (possibly in the
        # next batch) — they contribute no bytes of their own.
        return jnp.where(length > 0, s_last & (next_byte >= 0), carry_in != 0)

    return t, pv, match, lnm, carry_out(jnp.int32(0)), carry_out(jnp.int32(1))


def _row_phase2(t, pv, match, lnm, length, carry_in):
    """Per-row: resolve starts with the true carry, compact."""
    n = t.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    lz = jnp.maximum(lnm, jnp.int32(-1) - carry_in.astype(jnp.int32))
    starts = match & (((idx - lz) & 1) == 1)
    consumed = jnp.roll(starts, 1).at[0].set(carry_in & (length > 0))
    out_vals = jnp.where(starts, pv, t)
    keep = (~consumed) & (idx < length)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    count = jnp.where(n > 0, pos[-1] + 1, 0).astype(jnp.int32)
    scatter_idx = jnp.where(keep, pos, n)
    tokens = jnp.zeros((n,), dtype=jnp.int32).at[scatter_idx].set(
        out_vals, mode="drop", unique_indices=True
    )
    return tokens, count


def _compose_carry(f, g):
    """Compose boolean transfer functions: (g o f) as (out|in=0, out|in=1)."""
    f0, f1 = f
    g0, g1 = g
    return jnp.where(f0, g1, g0), jnp.where(f1, g1, g0)


@jax.jit
def sharded_flat_encode(
    batch: jnp.ndarray,  # uint8[B, N], rows = consecutive corpus chunks
    lengths: jnp.ndarray,  # int32[B]
    dense: jnp.ndarray,  # int32[65536], replicated
    carry_in: jnp.ndarray | bool = False,  # did the previous batch's final
    #   byte start a merge (consuming this batch's first byte)?
    next_byte_last: jnp.ndarray | int = -1,  # first byte of the NEXT batch
    #   (-1 at EOF), pairing the final valid byte across batch boundaries
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact flat BPE over a row-sharded batch.

    Returns (tokens[B,N], counts[B], carry_out). Output rows concatenated
    in order (each trimmed to its count) are bit-equal to single-sequence
    encoding of the concatenated input rows; threading ``carry_out`` into
    the next call's ``carry_in`` (with ``next_byte_last`` lookahead)
    extends that equality across an arbitrarily long stream of batches —
    the multi-device generalization of the single-device carry protocol
    (ops/bpe_jax.flat_encode).
    """
    b, n = batch.shape
    carry_in = jnp.asarray(carry_in, jnp.bool_)
    next_byte_last = jnp.asarray(next_byte_last, jnp.int32)
    # one-byte halo: first byte of the next non-empty row. Rows are filled
    # front-to-back, so an empty next row means every later row is empty
    # too and the stream continues at the next BATCH's first byte
    # (next_byte_last; -1 at EOF).
    first_bytes = batch[:, 0].astype(jnp.int32)
    nb = jnp.concatenate([first_bytes[1:], jnp.zeros((1,), jnp.int32)])
    nl = jnp.concatenate([lengths[1:], jnp.zeros((1,), jnp.int32)])
    next_bytes = jnp.where(nl > 0, nb, next_byte_last)

    t, pv, match, lnm, co0, co1 = jax.vmap(
        _row_phase1, in_axes=(0, 0, 0, None)
    )(batch, lengths, next_bytes, dense)

    # prefix-compose the per-row transfer functions; carry_in[r] applies the
    # composition of rows 0..r-1 to the batch-level carry_in.
    pref0, pref1 = jax.lax.associative_scan(_compose_carry, (co0, co1))
    pref_at = jnp.where(carry_in, pref1, pref0)
    row_carry_in = jnp.concatenate([carry_in[None], pref_at[:-1]])
    carry_out = pref_at[-1]

    tokens, counts = jax.vmap(_row_phase2)(
        t, pv, match, lnm, lengths, row_carry_in
    )
    return tokens, counts, carry_out


@jax.jit
def sharded_flat_encode_rowlocal(
    batch: jnp.ndarray, lengths: jnp.ndarray, dense: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row INDEPENDENT flat encode: no carry composition, no halo
    exchange, no collectives — deliberately NOT exact at row boundaries.

    Exists solely as the scaling benchmark's decomposition control: it
    runs the same per-row compute as sharded_flat_encode minus the
    associative carry scan and the next-byte shuffle, so the measured
    gap between the two isolates the partitioner/collective cost of the
    exact version (benches/scaling_benchmark.py --decompose).
    """
    t, pv, match, lnm, _, _ = jax.vmap(_row_phase1, in_axes=(0, 0, 0, None))(
        batch, lengths, jnp.full_like(lengths, -1), dense
    )
    tokens, counts = jax.vmap(_row_phase2)(
        t, pv, match, lnm, lengths, jnp.zeros_like(lengths, jnp.bool_)
    )
    return tokens, counts


@jax.jit
def sharded_basic_encode(batch: jnp.ndarray) -> jnp.ndarray:
    """uint8[B, N] -> uint16[B, N] widen; LE memory image is the u16-BE
    wire stream (embarrassingly parallel)."""
    return batch.astype(jnp.uint16) << 8


@jax.jit
def pair_count_hist(batch: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Global byte-pair frequency histogram (uint32[65536]).

    Row-local scatter-adds followed by a cross-row (cross-shard) sum — the
    psum/all-reduce of BASELINE.json's "per-pair count reductions".
    Includes row-boundary pairs via the same one-byte halo as encoding.
    """
    b, n = batch.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (b, n), 1)
    t = batch.astype(jnp.int32)
    nxt = jnp.roll(t, -1, axis=1)
    first_bytes = t[:, 0]
    next_bytes = jnp.concatenate([first_bytes[1:], jnp.array([-1], jnp.int32)])
    next_bytes = jnp.where(
        jnp.concatenate([lengths[1:], jnp.array([0], jnp.int32)]) > 0,
        next_bytes,
        -1,
    )
    last_i = jnp.maximum(lengths - 1, 0)
    nxt = nxt.at[jnp.arange(b), last_i].set(jnp.maximum(next_bytes, 0))
    valid = (idx < (lengths[:, None] - 1)) | (
        (idx == lengths[:, None] - 1) & (next_bytes[:, None] >= 0)
    )
    pair_idx = t * 256 + nxt

    def row_hist(pi, v):
        return jnp.zeros(65536, jnp.uint32).at[pi].add(v.astype(jnp.uint32))

    hists = jax.vmap(row_hist)(pair_idx, valid)
    return jnp.sum(hists, axis=0)
