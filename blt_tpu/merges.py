"""BPE merges-table loading and representation.

File grammar reproduced exactly from the reference loader
(reference: blt_core/src/config_loader.rs:14-46, pinned by its tests at
config_loader.rs:50-203):

- lines starting with ``#`` and *empty* lines are skipped (a whitespace-only
  line is NOT empty and is a format error);
- every other line must contain exactly two whitespace-separated u8 values
  (0-255; values >255 or non-numeric are errors with distinguishable
  "first"/"second" messages);
- new token ids are assigned 256, 257, ... **per valid line**, even when the
  pair duplicates an earlier line (last line wins the pair, the earlier id is
  orphaned) — pinned by config_loader.rs:167-202.

The in-memory representation is ``MergeTable``: a dict with exactly the
reference's ``BpeMerges = HashMap<(u16,u16),u16>`` shape (lib.rs:75), plus
device-ready dense/sparse lookup arrays. Because file-loaded tables always
have keys < 256 and values >= 256, they satisfy the *flat* property (merged
tokens can never re-merge), which the single-pass device program exploits;
the general multi-pass path covers arbitrary in-memory tables (e.g.
hierarchical rules like (256,99)->257 used by tokenizer.rs:204-212 tests).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

import numpy as np

BpeMerges = Dict[Tuple[int, int], int]

# Sentinel in dense lookup tables meaning "no rule for this pair". Must be
# outside u16 range so it can never collide with a real merge value.
NO_RULE = -1


class MergesFormatError(ValueError):
    """Malformed merges file (reference: io::ErrorKind::InvalidData)."""


def parse_merges_text(text: str) -> BpeMerges:
    """Parse merges-file text into the (u16,u16)->u16 map.

    Exact semantics of config_loader.rs:14-46 including id accounting.
    """
    merges: BpeMerges = {}
    vocab_size = 256
    for line in text.splitlines():
        if line.startswith("#") or line == "":
            continue
        parts = line.split()
        if len(parts) != 2:
            raise MergesFormatError(
                f"Invalid merge rule format in line: '{line}'. "
                "Expected two numbers separated by space."
            )
        byte1 = _parse_u8(parts[0], "first", line)
        byte2 = _parse_u8(parts[1], "second", line)
        merges[(byte1, byte2)] = vocab_size
        vocab_size += 1
    return merges


def _parse_u8(token: str, which: str, line: str) -> int:
    try:
        # Rust's u8::parse accepts an optional leading '+' and digits only.
        t = token[1:] if token.startswith("+") else token
        if not (t and all(c.isdigit() and c.isascii() for c in t)):
            raise ValueError("invalid digit found in string")
        value = int(t)
        if value > 255:
            raise ValueError("number too large to fit in target type")
        return value
    except ValueError as e:
        raise MergesFormatError(
            f"Failed to parse {which} byte value: {e} in line '{line}'"
        ) from None


def load_bpe_merges_from_path(path: str | os.PathLike) -> BpeMerges:
    """Load merges from a file path (config_loader.rs:14 entry point)."""
    with io.open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_merges_text(f.read())


def load_bpe_merges(path: str | os.PathLike) -> Dict[Tuple[int, int], int]:
    """Public u8-pair loader mirroring ``blt.load_bpe_merges``.

    Reference: blt_core/src/lib.rs:216-230 filters pairs to u8 range for the
    Python API; file-loaded pairs are always u8 so this is the identity here.
    """
    merges = load_bpe_merges_from_path(path)
    return {(a, b): t for (a, b), t in merges.items() if a <= 255 and b <= 255}


@dataclass
class MergeTable:
    """Device-ready merge table.

    ``flat`` means no rule *value* ever appears as a member of any rule *key*,
    so a merged token can never participate in a later merge. In that case the
    whole multi-pass reference algorithm (tokenizer.rs:63-86) provably
    terminates after one merging pass, and the device program runs a single
    parity-scan pass over raw bytes — exactly bit-equal to the reference run
    with chunk size >= input. File-loaded tables (keys < 256, values >= 256)
    are always flat.
    """

    merges: BpeMerges
    # Dense [256*256] int32 lookup for byte-pair keys: value or NO_RULE.
    dense: np.ndarray = field(repr=False)
    # True if the single-pass flat kernel is exact for this table.
    flat: bool = False
    # Sparse u32-key table for general (u16,u16) keys, sorted for searchsorted.
    sparse_keys: np.ndarray = field(repr=False, default=None)
    sparse_vals: np.ndarray = field(repr=False, default=None)

    @staticmethod
    def build(merges: Mapping[Tuple[int, int], int]) -> "MergeTable":
        merges = dict(merges)
        for (a, b), v in merges.items():
            # the reference's BpeMerges is HashMap<(u16,u16),u16> (lib.rs:75);
            # Python ints need the range check the Rust types gave for free
            if not (0 <= a <= 0xFFFF and 0 <= b <= 0xFFFF and 0 <= v <= 0xFFFF):
                raise ValueError(
                    f"merge rule ({a},{b})->{v} outside the u16 token range"
                )
        dense = np.full(256 * 256, NO_RULE, dtype=np.int32)
        key_members = set()
        for (a, b), v in merges.items():
            key_members.add(a)
            key_members.add(b)
            if a < 256 and b < 256:
                dense[a * 256 + b] = v
        values = set(merges.values())
        all_keys_byte = all(a < 256 and b < 256 for a, b in merges)
        flat = all_keys_byte and not (values & key_members)

        keys = np.array(
            sorted((a << 16) | b for a, b in merges), dtype=np.uint32
        )
        lut = {(a << 16) | b: v for (a, b), v in merges.items()}
        vals = np.array([lut[int(k)] for k in keys], dtype=np.int32)
        return MergeTable(
            merges=merges,
            dense=dense,
            flat=flat,
            sparse_keys=keys,
            sparse_vals=vals,
        )

    def __len__(self) -> int:
        return len(self.merges)
