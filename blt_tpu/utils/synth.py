"""Seeded synthetic corpora and merge tables for on-card checks.

Used by ``chip_smoke.py``, the ``gpu``-marked tests and the device-trace
tool, so every one of them runs the same workload: Zipf-weighted text bytes
and a flat table of the corpus's most frequent byte pairs (500 rules by
default), optionally extended with second-level rules over merged tokens (a
hierarchical table, which only the multi-pass path can run).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

ALPHABET = b"etaoinshrdlucmfwypvbgkjqxz ETAOIN,.;:'\"!?0123456789\n"
FLAT_RULES = 500

Merges = Dict[Tuple[int, int], int]


def zipf_text(seed: int, n: int) -> np.ndarray:
    """``n`` bytes of Zipf-weighted text drawn from ``ALPHABET``."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(ALPHABET, np.uint8)
    weights = 1.0 / np.arange(1, alphabet.size + 1)
    idx = rng.choice(alphabet.size, size=n, p=weights / weights.sum())
    return alphabet[idx.astype(np.intp)]


def top_pair_merges(sample: np.ndarray, rules: int = FLAT_RULES) -> Merges:
    """Flat table: the ``rules`` most frequent byte pairs of ``sample``,
    most frequent first, ids 256, 257, ... (a merges file's own order)."""
    pairs = sample[:-1].astype(np.int64) * 256 + sample[1:]
    counts = np.bincount(pairs, minlength=65536)
    order = np.argsort(-counts, kind="stable")[:rules]
    order = order[counts[order] > 0]
    return {(int(p) // 256, int(p) % 256): 256 + i for i, p in enumerate(order)}


def merges_file_text(merges: Merges) -> str:
    """A merges file that loads back to ``merges`` (ids in file order)."""
    items = sorted(merges.items(), key=lambda kv: kv[1])
    assert [v for _, v in items] == list(range(256, 256 + len(items)))
    return "".join(f"{a} {b}\n" for (a, b), _ in items)


def hierarchical_merges(
    sample: np.ndarray, flat: Merges, rules: int = 100
) -> Merges:
    """``flat`` plus ``rules`` second-level rules: the most frequent token
    pairs of ``sample`` after the flat pass that hold at least one merged
    token, each mapped to the next free id. Not flat by construction."""
    from blt_tpu.merges import MergeTable
    from blt_tpu.ops.bpe_numpy import bpe_encode_flat

    tokens = bpe_encode_flat(sample, MergeTable.build(flat)).astype(np.int64)
    keys = tokens[:-1] * 65536 + tokens[1:]
    keys = keys[(tokens[:-1] >= 256) | (tokens[1:] >= 256)]
    uniq, counts = np.unique(keys, return_counts=True)
    top = uniq[np.argsort(-counts, kind="stable")[:rules]]
    out = dict(flat)
    next_id = 256 + len(flat)
    for k in top:
        out[(int(k) // 65536, int(k) % 65536)] = next_id
        next_id += 1
    return out
