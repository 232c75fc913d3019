"""Adversarial inputs through every device path, against the oracle (CPU).

Each case runs through four targets:

* ``flat_encode``  — ``bpe_jax.flat_encode`` piece by piece, chained through
  carry-in and next-byte (flat tables);
* ``multipass``    — ``bpe_jax.multipass_encode`` per chunk against
  ``bpe_numpy.bpe_encode_multipass``;
* ``jax_engine``   — ``JaxEngine.bpe_stream``;
* ``sharded_gpu``  — ``ShardedJaxEngine`` over 4 virtual devices with the
  backend platform stubbed as ``gpu``: the engine AUTO builds on a
  four-card host.

Flat tables must be chunk-size invariant (the whole-input oracle);
hierarchical tables keep the reference's per-chunk semantics.
"""

import numpy as np
import pytest

from blt_tpu.merges import MergeTable
from blt_tpu.ops import bpe_numpy
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes

CHUNK = 4096  # one padded shape per target: one compile shared by all cases


def _text(alphabet: bytes, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def _random_pairs(seed: int, k: int):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < k:
        pairs.add((int(rng.integers(0, 256)), int(rng.integers(0, 256))))
    return {p: 256 + i for i, p in enumerate(sorted(pairs))}


AAB = {(97, 97): 256, (97, 98): 257}
ABC = {(97, 98): 256, (98, 99): 257, (99, 97): 258}

FLAT_CASES = {
    # parity chain across every chunk boundary, odd tail
    "all_match_run": (
        {(97, 97): 256}, np.full(65536 + 12345, 97, np.uint8)),
    # the run starts one byte into the stream: every boundary is mid-pair
    "all_match_offset": (
        {(97, 97): 256},
        np.concatenate([[120], np.full(3 * CHUNK, 97)]).astype(np.uint8)),
    # (255,255)->0xFFFF: the largest token value
    "ffff_rule": (
        {(255, 255): 0xFFFF, (97, 98): 256},
        np.frombuffer(b"ab\xff\xff\xffab" * 1500, np.uint8)),
    # FF FF bytes with no (255,255) rule must stay unmerged
    "ffff_without_rule": (
        {(97, 98): 300}, np.frombuffer(b"ab\xff\xffab\xff" * 1500, np.uint8)),
    "ffff_other_rule": (
        {(97, 98): 300, (255, 255): 301},
        np.frombuffer(b"ab\xff\xffab\xff" * 1500, np.uint8)),
    "ffff_near_miss": (
        {(255, 254): 400}, np.frombuffer(b"\xff\xff\xfe\xff" * 3000, np.uint8)),
    "full_byte_range": (
        _random_pairs(0xFF, 300),
        np.random.default_rng(0xFF).integers(0, 256, 50_000, np.uint8)),
    # merges landing exactly on, and straddling, chunk boundaries
    "boundary_straddle": (ABC, _text(b"abcabcaabbcc", 5 * CHUNK + 1, 3)),
    "size_1": (AAB, _text(b"aab", 1, 1)),
    "size_2": (AAB, np.frombuffer(b"aa", np.uint8)),
    "size_127": (AAB, _text(b"aab", 127, 2)),
    "size_128": (AAB, _text(b"aab", 128, 3)),
    "size_129": (AAB, _text(b"aab", 129, 4)),
    "size_64k_minus_1": (AAB, _text(b"aab", 65535, 5)),
    "size_64k": (AAB, _text(b"aab", 65536, 6)),
    "size_64k_plus_1": (AAB, _text(b"aab", 65537, 7)),
    # merged values below 256 (still flat: no value is a key member)
    "value_below_256": ({(120, 121): 90}, _text(b"xyzxyyx", 9000, 8)),
    # the last chunk is one byte, consumed by the previous chunk's merge
    "carry_into_eof_byte": (
        {(97, 97): 256},
        np.concatenate([[120], np.full(CHUNK, 97)]).astype(np.uint8)),
    "no_rules": ({}, _text(b"abcdef", 10_000, 9)),
}

HIER_CASES = {
    "hierarchical": (
        {(97, 98): 256, (256, 99): 257, (257, 257): 300},
        _text(b"abcabcabcx", 4000, 11)),
    # merged values collide with byte values, including 0
    "value_collision_and_zero": (
        {(120, 121): 90, (90, 122): 0, (0, 97): 400},
        np.frombuffer(b"axyzaxyza" * 400, np.uint8)),
    "multi_level_all_match": (
        {(97, 97): 256, (256, 256): 257, (257, 257): 258},
        np.full(3 * CHUNK + 777, 97, np.uint8)),
    "chained_rules_random": (
        {(97, 98): 256, (98, 97): 257, (256, 257): 258, (258, 99): 259,
         (259, 259): 260},
        _text(b"abbac", 2 * CHUNK + 5, 13)),
    "tiny_chunks": (
        {(97, 98): 256, (256, 99): 257},
        _text(b"abc", 5, 14)),
}


def _chunks(data: np.ndarray):
    return [data[i : i + CHUNK] for i in range(0, data.shape[0], CHUNK)]


def _expected_flat(merges, data) -> bytes:
    return tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), merges))


def _expected_per_chunk(merges, data) -> bytes:
    return b"".join(
        tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), merges))
        for c in _chunks(data)
    )


def _padded(chunk: np.ndarray):
    import jax.numpy as jnp

    buf = np.zeros(CHUNK, np.uint8)
    buf[: chunk.shape[0]] = chunk
    return jnp.asarray(buf)


def run_flat_encode(table, chunks, monkeypatch) -> bytes:
    """Piece by piece through flat_encode, carries threaded on device; each
    piece also checked against the host carry-chained reference."""
    import jax.numpy as jnp

    from blt_tpu.ops import bpe_jax

    dense = bpe_jax.dense_table_device(table)
    carry = jnp.asarray(False)
    host_carry = False
    out = b""
    for i, chunk in enumerate(chunks):
        nxt = int(chunks[i + 1][0]) if i + 1 < len(chunks) else -1
        _, count, carry, be = bpe_jax.flat_encode(
            _padded(chunk), jnp.int32(chunk.shape[0]), dense, carry,
            jnp.int32(nxt))
        piece = np.asarray(be)[: int(count)].tobytes()
        want, host_carry = bpe_numpy.bpe_encode_flat_carry(
            chunk, table, host_carry, nxt)
        assert piece == want.astype(">u2").tobytes(), f"piece {i}"
        assert bool(carry) == host_carry, f"carry after piece {i}"
        out += piece
    return out


def run_multipass(table, chunks, monkeypatch) -> bytes:
    import jax.numpy as jnp

    from blt_tpu.ops import bpe_jax

    keys, vals = bpe_jax.sparse_table_device(table)
    out = b""
    for chunk in chunks:
        toks, count = bpe_jax.multipass_encode(
            _padded(chunk), jnp.int32(chunk.shape[0]), keys, vals)
        piece = np.asarray(
            bpe_jax.tokens_to_be_bytes_device(toks))[: int(count)].tobytes()
        want = bpe_numpy.bpe_encode_multipass(chunk, table)
        assert piece == want.astype(">u2").tobytes()
        out += piece
    return out


def run_jax_engine(table, chunks, monkeypatch) -> bytes:
    from blt_tpu.pipeline.engines import JaxEngine

    return b"".join(
        bytes(x) for x in JaxEngine().bpe_stream(iter(chunks), table, CHUNK))


def run_sharded_gpu(table, chunks, monkeypatch) -> bytes:
    import jax

    from blt_tpu.parallel.mesh import make_mesh
    from blt_tpu.pipeline import engines as eng

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    monkeypatch.setattr(eng, "backend_platform", lambda: "gpu")
    engine = eng.ShardedJaxEngine(mesh=make_mesh(jax.devices()[:4]))
    return b"".join(
        bytes(x) for x in engine.bpe_stream(iter(chunks), table, CHUNK))


FLAT_TARGETS = {
    "flat_encode": run_flat_encode,
    "multipass": run_multipass,
    "jax_engine": run_jax_engine,
    "sharded_gpu": run_sharded_gpu,
}
HIER_TARGETS = {k: v for k, v in FLAT_TARGETS.items() if k != "flat_encode"}


@pytest.mark.parametrize("target", sorted(FLAT_TARGETS))
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_table_case(case, target, monkeypatch):
    merges, data = FLAT_CASES[case]
    table = MergeTable.build(merges)
    assert table.flat
    chunks = _chunks(data)
    got = FLAT_TARGETS[target](table, chunks, monkeypatch)
    if target == "multipass":
        # multi-pass keeps per-chunk semantics by construction
        assert got == _expected_per_chunk(merges, data)
    else:
        assert got == _expected_flat(merges, data)


@pytest.mark.parametrize("target", sorted(HIER_TARGETS))
@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_hierarchical_table_case(case, target, monkeypatch):
    merges, data = HIER_CASES[case]
    table = MergeTable.build(merges)
    assert not table.flat
    got = HIER_TARGETS[target](table, _chunks(data), monkeypatch)
    assert got == _expected_per_chunk(merges, data)


def test_auto_on_four_gpu_host_picks_sharded_flat_path(monkeypatch):
    """A host reporting a gpu backend with several devices gets the sharded
    engine from AUTO, and its flat BPE runs the carry-composition path."""
    import jax

    from blt_tpu.config import Engine
    from blt_tpu.pipeline import engines as eng

    monkeypatch.setattr(eng, "backend_platform", lambda: "gpu")
    engine = eng.select_engine(Engine.AUTO, eng.AUTO_DEVICE_THRESHOLD)
    assert isinstance(engine, eng.ShardedJaxEngine)
    assert engine.n_rows == len(jax.devices())
    merges, data = FLAT_CASES["all_match_run"]
    got = b"".join(bytes(x) for x in engine.bpe_stream(
        iter(_chunks(data)), MergeTable.build(merges), CHUNK))
    assert got == _expected_flat(merges, data)
