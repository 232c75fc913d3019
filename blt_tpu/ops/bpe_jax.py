"""JAX/XLA device programs for tokenization (the device compute path).

Data-parallel re-derivation of the reference's sequential merge scan
(reference: blt_core/src/tokenizer.rs:56-93). Two device paths:

1. ``flat_encode`` — single parity-scan pass over raw bytes, exact for flat
   tables (every file-loadable table; see blt_tpu.merges.MergeTable.flat).
   The whole device batch is treated as ONE flattened global byte sequence,
   so chunk boundaries inside a batch cost nothing, and consecutive batches
   are stitched exactly via an O(1) carry: ``carry_in`` says the batch's
   first byte was consumed by a merge that ended the previous batch;
   ``next_byte`` is a one-byte halo from the following batch so a merge may
   start on the final byte. Output is bit-equal to the reference run with
   chunk size >= input ("chunk-size invariance", SURVEY.md 2.1.6).

2. ``multipass_encode`` — ``lax.while_loop`` over whole-sequence passes for
   arbitrary tables (hierarchical rules, value/byte collisions), exact
   reference per-buffer semantics.

All shapes are static (buffers padded to a fixed N); dynamic state is carried
as scalar lengths, keeping everything jit-compiled once per buffer size.
Primitive mapping:
  pair lookup      -> jnp.take of a dense 64K-entry table
  leftmost-first   -> run-parity resolve via lax.cummax (log-depth scan)
  compaction       -> cumsum + unique-index scatter
  u16 BE emission  -> elementwise shift/mask + interleave on device

The in-pass recurrence being parallelized is

    merge_start[i] = match[i] AND NOT merge_start[i-1]

whose solution over each maximal run of consecutive matches alternates
true/false from the run head. ``carry_in`` extends the run virtually one
position to the left (merge_start[-1] = carry), which shifts the parity of
the initial run only.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from blt_tpu.merges import NO_RULE, MergeTable

# Plain int (not a device array): module import must never touch a backend.
_NEG_INF32 = -(2**31) + 1


def _last_nonmatch(match: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Cummax of the most recent non-match position (very negative if none)."""
    return jax.lax.cummax(jnp.where(match, _NEG_INF32, idx))


def _starts_from_scan(
    match: jnp.ndarray, lnm: jnp.ndarray, idx: jnp.ndarray, carry: jnp.ndarray
) -> jnp.ndarray:
    """merge_start flags given the last-nonmatch scan and a carry-in bit.

    The virtual sentinel is -1 (no carry) or -2 (carry: a merge started at
    position -1 and consumed position 0), which flips the parity of the
    initial run of matches and leaves everything after the first real
    non-match untouched.
    """
    sentinel = jnp.int32(-1) - carry.astype(jnp.int32)
    lz = jnp.maximum(lnm, sentinel)
    return match & (((idx - lz) & 1) == 1)


def _compact(vals: jnp.ndarray, keep: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stream compaction: gather kept vals to the front; returns (out, count)."""
    n = vals.shape[0]
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    count = jnp.where(n > 0, pos[-1] + 1, 0).astype(jnp.int32)
    scatter_idx = jnp.where(keep, pos, n)
    out = jnp.zeros((n,), dtype=vals.dtype).at[scatter_idx].set(
        vals, mode="drop", unique_indices=True
    )
    return out, count


@functools.partial(jax.jit, static_argnames=("emit_bytes",))
def flat_encode(
    data: jnp.ndarray,  # uint8[N] padded byte buffer (flattened batch)
    length: jnp.ndarray,  # int32 scalar: valid bytes
    dense: jnp.ndarray,  # int32[65536] pair->value table, NO_RULE = miss
    carry_in: jnp.ndarray,  # bool scalar: first byte already consumed
    next_byte: jnp.ndarray,  # int32 scalar: first byte of next batch, -1=EOF
    emit_bytes: bool = True,
):
    """Single-pass flat BPE over a padded byte buffer with batch stitching.

    Returns (tokens int32[N] compacted, token_count, carry_out bool,
    and optionally the u16-BE byte stream uint8[2N]). ``carry_out`` is True
    when a merge started on the final valid byte and consumed ``next_byte``
    (the merged token is emitted in THIS batch's stream; the next batch must
    be called with carry_in=True).
    """
    n = data.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    t = data.astype(jnp.int32)
    nxt = jnp.roll(t, -1)
    last_i = jnp.maximum(length - 1, 0)
    nxt = nxt.at[last_i].set(jnp.where(next_byte >= 0, next_byte, 0))
    valid_pair = (idx < (length - 1)) | ((idx == length - 1) & (next_byte >= 0))

    in_range = (t < 256) & (nxt < 256)
    pair_idx = jnp.where(in_range, t * 256 + nxt, 0)
    pv = jnp.take(dense, pair_idx)
    match = valid_pair & in_range & (pv != NO_RULE)

    lnm = _last_nonmatch(match, idx)
    starts = _starts_from_scan(match, lnm, idx, carry_in)
    consumed = jnp.roll(starts, 1).at[0].set(carry_in & (length > 0))

    out_vals = jnp.where(starts, pv, t)
    keep = (~consumed) & (idx < length)
    tokens, count = _compact(out_vals, keep)

    carry_out = jnp.where(length > 0, starts[last_i] & (next_byte >= 0), False)

    if emit_bytes:
        be = tokens_to_be_bytes_device(tokens)
        return tokens, count, carry_out, be
    return tokens, count, carry_out


@jax.jit
def tokens_to_be_bytes_device(tokens: jnp.ndarray) -> jnp.ndarray:
    """int32[N] token ids -> uint16[N] whose LE memory image is the u16-BE
    wire stream (a byteswap, pure elementwise: no interleave or stack)."""
    swapped = ((tokens & 0xFF) << 8) | ((tokens >> 8) & 0xFF)
    return swapped.astype(jnp.uint16)


@jax.jit
def basic_encode(data: jnp.ndarray) -> jnp.ndarray:
    """uint8[N] -> uint16[N] byte->u16 widen whose LE memory image is the
    u16-BE stream (value b<<8 stores as [0, b]).

    Reference semantics: tokenizer.rs:116-122 (token value == byte value).
    """
    return data.astype(jnp.uint16) << 8


def _sparse_lookup(
    tokens: jnp.ndarray,
    next_tok: jnp.ndarray,
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    valid_pair: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sorted-key binary search for general (u16,u16) rule keys."""
    k = (tokens.astype(jnp.uint32) << 16) | next_tok.astype(jnp.uint32)
    pos = jnp.searchsorted(keys, k)
    pos_c = jnp.minimum(pos, keys.shape[0] - 1)
    v = vals[pos_c]
    hit = (keys[pos_c] == k) & valid_pair & (v != NO_RULE)
    return jnp.where(hit, v, NO_RULE), hit


@jax.jit
def multipass_encode(
    data: jnp.ndarray,  # uint8[N] padded
    length: jnp.ndarray,  # int32 scalar
    keys: jnp.ndarray,  # uint32[R] sorted pair keys (a<<16 | b)
    vals: jnp.ndarray,  # int32[R] merge values (NO_RULE entries are ignored)
):
    """Whole-sequence passes until quiescence (tokenizer.rs:63-86 semantics).

    Exact for arbitrary tables including hierarchical rules. State is a
    fixed-size token buffer plus a scalar length; each pass is the same
    lookup -> parity-scan -> compaction pipeline as the flat kernel.
    """
    n = data.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    no_carry = jnp.bool_(False)

    def one_pass(state):
        tokens, cur_len, _ = state
        nxt = jnp.roll(tokens, -1)
        valid_pair = idx < (cur_len - 1)
        pv, match = _sparse_lookup(tokens, nxt, keys, vals, valid_pair)
        lnm = _last_nonmatch(match, idx)
        starts = _starts_from_scan(match, lnm, idx, no_carry)
        consumed = jnp.roll(starts, 1).at[0].set(False)
        out_vals = jnp.where(starts, pv, tokens)
        keep = (~consumed) & (idx < cur_len)
        new_tokens, new_len = _compact(out_vals, keep)
        return new_tokens, new_len, jnp.any(starts)

    def cond(state):
        _, cur_len, merges_found = state
        return merges_found & (cur_len >= 2)

    init = (data.astype(jnp.int32), length, jnp.bool_(True))
    tokens, out_len, _ = jax.lax.while_loop(cond, one_pass, init)
    return tokens, out_len


# One chunk per row of a (B, N) batch: the multi-device engine's general-
# table path (rows sharded over the mesh, tables replicated).
multipass_encode_rows = jax.jit(
    jax.vmap(multipass_encode, in_axes=(0, 0, None, None))
)


def dense_table_device(table: MergeTable) -> jnp.ndarray:
    """Upload the dense pair table once (Arc<BpeMerges> replication analog)."""
    return jnp.asarray(table.dense)


def sparse_table_device(table: MergeTable) -> Tuple[jnp.ndarray, jnp.ndarray]:
    keys = table.sparse_keys
    vals = table.sparse_vals
    if keys is None or len(keys) == 0:
        # Keep shapes non-empty and static; the NO_RULE value guarantees the
        # placeholder entry can never register as a hit.
        keys = np.array([0xFFFFFFFF], dtype=np.uint32)
        vals = np.array([NO_RULE], dtype=np.int32)
    return jnp.asarray(keys), jnp.asarray(vals)
