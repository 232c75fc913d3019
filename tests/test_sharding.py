"""Multi-device sharding tests on an 8-virtual-device CPU mesh.

The reference has no distributed layer (SURVEY.md 2); these tests pin the
BASELINE.json north-star behaviors: row-sharded corpus, replicated merges,
exact cross-shard carry resolution, psum-style pair-count reduction.
"""

import numpy as np
import pytest

import jax

from blt_tpu.merges import MergeTable
from blt_tpu.ops import bpe_numpy
from blt_tpu.parallel.mesh import make_mesh, replicated, row_sharding, vec_sharding
from blt_tpu.parallel.sharded import (
    pair_count_hist,
    sharded_basic_encode,
    sharded_flat_encode,
)



@pytest.fixture(autouse=True)
def _multi_device():
    # decided per test, never at import: every xdist worker collects the
    # same tests whatever its backend
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")

MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259}


def make_batch(corpus: np.ndarray, b: int, n: int):
    batch = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for r in range(b):
        row = corpus[r * n : (r + 1) * n]
        batch[r, : row.shape[0]] = row
        lengths[r] = row.shape[0]
    return batch, lengths


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_sharded_flat_encode_exact(mesh):
    rng = np.random.default_rng(3)
    table = MergeTable.build(MERGES)
    b, n = len(jax.devices()), 1024
    corpus = rng.choice(
        np.frombuffer(b"abcabcaabbccaaaa", np.uint8), size=b * n - 100
    ).astype(np.uint8)
    batch, lengths = make_batch(corpus, b, n)

    batch_d = jax.device_put(batch, row_sharding(mesh))
    lengths_d = jax.device_put(lengths, vec_sharding(mesh))
    dense_d = jax.device_put(table.dense, replicated(mesh))

    tokens, counts, _ = sharded_flat_encode(batch_d, lengths_d, dense_d)
    tokens_h, counts_h = np.asarray(tokens), np.asarray(counts)
    got = np.concatenate([tokens_h[r, : counts_h[r]] for r in range(b)])
    expected = bpe_numpy.bpe_encode_flat(corpus, table)
    assert got.tolist() == expected.tolist()


def test_sharded_flat_encode_adversarial_runs(mesh):
    """All-'aa' corpus: the parity chain crosses every shard boundary."""
    table = MergeTable.build({(97, 97): 256})
    b, n = len(jax.devices()), 256
    # odd total length forces a trailing unmerged byte
    corpus = np.full(b * n - 1, 97, np.uint8)
    batch, lengths = make_batch(corpus, b, n)
    tokens, counts, _ = sharded_flat_encode(
        jax.device_put(batch, row_sharding(mesh)),
        jax.device_put(lengths, vec_sharding(mesh)),
        jax.device_put(table.dense, replicated(mesh)),
    )
    tokens_h, counts_h = np.asarray(tokens), np.asarray(counts)
    got = np.concatenate([tokens_h[r, : counts_h[r]] for r in range(b)])
    expected = bpe_numpy.bpe_encode_flat(corpus, table)
    assert got.tolist() == expected.tolist()
    # (b*n-1) 'a's -> (b*n-2)/2 merged pairs + 1 leftover
    assert got.shape[0] == (b * n - 2) // 2 + 1


def test_sharded_basic_encode(mesh):
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 256, (len(jax.devices()), 512), dtype=np.uint8)
    out = np.asarray(sharded_basic_encode(jax.device_put(batch, row_sharding(mesh))))
    for r in range(batch.shape[0]):
        assert out[r].tobytes() == batch[r].astype(">u2").tobytes()


def test_pair_count_hist(mesh):
    corpus = np.frombuffer(b"ababab" * 100, np.uint8).copy()
    b, n = len(jax.devices()), 128
    batch, lengths = make_batch(corpus, b, n)
    hist = np.asarray(
        pair_count_hist(
            jax.device_put(batch, row_sharding(mesh)),
            jax.device_put(lengths, vec_sharding(mesh)),
        )
    )
    # 600 bytes -> 599 adjacent pairs: 300x (a,b), 299x (b,a)
    assert hist.sum() == corpus.shape[0] - 1
    assert hist[97 * 256 + 98] == 300
    assert hist[98 * 256 + 97] == 299


def test_learn_bpe_roundtrip(tmp_path):
    from blt_tpu.merges import load_bpe_merges_from_path
    from blt_tpu.parallel.train import learn_bpe, save_merges

    corpus = b"the cat sat on the mat " * 50
    merges = learn_bpe(corpus, 8)
    assert len(merges) == 8
    # most frequent first pair in this corpus is one of the repeating bigrams
    ids = sorted(merges.values())
    assert ids == list(range(256, 264))
    # byte-pair-only prefix round-trips through the reference file grammar
    byte_rules = {k: v for k, v in merges.items() if k[0] < 256 and k[1] < 256}
    p = tmp_path / "m.txt"
    save_merges(merges, p)
    loaded = load_bpe_merges_from_path(p)
    if len(byte_rules) == len(merges):
        assert loaded == merges


def test_learn_bpe_sharded_matches_single_device(mesh):
    """Sharded training (global count reduction) learns the same rules as
    the single-device trainer when no boundary pair is ever the winner."""
    from blt_tpu.parallel.train import learn_bpe, learn_bpe_sharded
    from blt_tpu.parallel.mesh import row_sharding, vec_sharding

    corpus = (b"the cat sat on the mat | " * 64)[:-2]
    b, n = len(jax.devices()), 256
    arr = np.frombuffer(corpus, np.uint8)
    batch = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for r in range(b):
        row = arr[r * n : (r + 1) * n]
        batch[r, : row.shape[0]] = row
        lengths[r] = row.shape[0]

    sharded = learn_bpe_sharded(
        np.asarray(jax.device_put(batch, row_sharding(mesh))),
        np.asarray(jax.device_put(lengths, vec_sharding(mesh))),
        6,
    )
    single = learn_bpe(corpus, 6)
    # same rule count and id policy; exact rule sets can diverge because
    # sharded counting excludes row-boundary pairs (documented), which
    # shifts tie-breaks and cascades through hierarchical rule ids
    assert len(sharded) == len(single) == 6
    assert sorted(sharded.values()) == sorted(single.values()) == list(
        range(256, 262)
    )
    # the learned table actually compresses the training corpus
    from blt_tpu.ops.bpe_numpy import bpe_encode
    from blt_tpu.merges import MergeTable as MT

    toks = bpe_encode(arr, MT.build(sharded))
    assert len(toks) < 0.8 * arr.shape[0]


def test_train_checkpoint_resume(tmp_path):
    """An interrupted run resumed from its checkpoint matches a clean run."""
    import numpy as np

    from blt_tpu.parallel.train import (
        learn_bpe_sharded,
        load_checkpoint,
        save_checkpoint,
    )

    rng = np.random.default_rng(5)
    batch = rng.choice(
        np.frombuffer(b"abcabcaabb  ", np.uint8), size=(4, 512)
    ).astype(np.uint8)
    lengths = np.full(4, 512, np.int32)
    ckpt = str(tmp_path / "train.ckpt.npz")

    clean = learn_bpe_sharded(batch, lengths, 6)

    # "crash" after 3 rules: run with a smaller budget, checkpointing
    learn_bpe_sharded(
        batch, lengths, 3, checkpoint_path=ckpt, checkpoint_every=1
    )
    merges, new_id, tok, lens = load_checkpoint(ckpt)
    assert len(merges) == 3 and new_id == 259
    # resume to the full budget; must equal the uninterrupted result
    resumed = learn_bpe_sharded(
        batch, lengths, 6, checkpoint_path=ckpt, checkpoint_every=2, resume=True
    )
    assert resumed == clean
    # checkpoint rewritten at completion and loadable
    merges2, new_id2, _, _ = load_checkpoint(ckpt)
    assert merges2 == clean and new_id2 == 256 + len(clean)

    # atomicity artifact: no stray tmp file left behind
    assert not (tmp_path / "train.ckpt.npz.tmp").exists()

    # save/load round-trip preserves dtypes and state exactly
    save_checkpoint(ckpt, merges2, tok, lens, new_id2)
    m3, n3, t3, l3 = load_checkpoint(ckpt)
    assert m3 == merges2 and n3 == new_id2
    assert np.array_equal(t3, tok) and np.array_equal(l3, lens)


def test_sharded_engine_pipeline_exact(tmp_path):
    """CLI-level --engine shard: file->file over the 8-device mesh must be
    byte-identical to the host engine, across multiple device batches
    (exercising the threaded batch carry) and a ragged final batch."""
    from blt_tpu.config import CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer

    rng = np.random.default_rng(11)
    # > 2 device batches (conftest sets BLT_DEVICE_BATCH_BYTES=256KB) with a
    # ragged tail; 'a'-heavy so parity chains cross row and batch edges
    corpus = rng.choice(
        np.frombuffer(b"abcabcaabbccaaaa", np.uint8), size=700_001
    ).tobytes()
    ip = tmp_path / "in.bin"
    ip.write_bytes(corpus)
    mp = tmp_path / "merges.txt"
    mp.write_text("97 98\n98 99\n99 97\n97 97\n")

    for merges in (None, mp):
        outs = {}
        for engine in (Engine.NUMPY, Engine.SHARD):
            op = tmp_path / f"out_{engine.value}.bin"
            run_tokenizer(
                CoreConfig.new_from_cli(
                    input=ip, output=op, merges=merges, engine=engine
                )
            )
            outs[engine] = op.read_bytes()
        assert outs[Engine.SHARD] == outs[Engine.NUMPY], (
            f"shard/host mismatch (merges={merges is not None})"
        )


def test_sharded_engine_all_a_adversarial(tmp_path):
    """All-'aa' stream: every row and batch boundary carries a pending
    merge; output must equal the single-sequence host encode."""
    from blt_tpu.config import CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer

    corpus = b"a" * 600_001  # odd: trailing unmerged byte
    ip = tmp_path / "in.bin"
    ip.write_bytes(corpus)
    mp = tmp_path / "merges.txt"
    mp.write_text("97 97\n")
    op1 = tmp_path / "shard.bin"
    op2 = tmp_path / "host.bin"
    run_tokenizer(CoreConfig.new_from_cli(
        input=ip, output=op1, merges=mp, engine=Engine.SHARD))
    run_tokenizer(CoreConfig.new_from_cli(
        input=ip, output=op2, merges=mp, engine=Engine.NUMPY))
    assert op1.read_bytes() == op2.read_bytes()


def test_sharded_engine_hierarchical_multipass(tmp_path):
    """General (non-flat) tables in the shard engine run row-parallel over
    the mesh with per-chunk reference semantics: output must equal the host
    engine at the same chunk size."""
    from blt_tpu.config import CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer

    rng = np.random.default_rng(5)
    corpus = rng.choice(
        np.frombuffer(b"abcabcdeab", np.uint8), size=700_000
    ).tobytes()
    ip = tmp_path / "in.bin"
    ip.write_bytes(corpus)
    merges = {(97, 98): 256, (256, 99): 257, (257, 100): 258}  # hierarchical

    outs = {}
    for engine in (Engine.NUMPY, Engine.SHARD):
        op = tmp_path / f"out_{engine.value}.bin"
        cfg = CoreConfig.new_from_cli(
            input=ip, output=op, chunksize="256KB", engine=engine
        )
        cfg.with_merges(merges)
        run_tokenizer(cfg)
        outs[engine] = op.read_bytes()
    assert outs[Engine.SHARD] == outs[Engine.NUMPY]
    assert len(outs[Engine.SHARD]) > 0


def test_sharded_engine_stream_short_reads_carry(tmp_path, monkeypatch):
    """stdin stream with short reads: intermediate batches get empty
    trailing rows, and an all-'a' corpus forces a pending merge carry to
    pass THROUGH those empty rows into the next batch (identity transfer
    functions). Output must equal the host engine on the same bytes."""
    import io
    import sys

    from blt_tpu.config import CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer

    data = b"a" * 300_001  # odd -> trailing unmerged byte at EOF

    class ShortStdin:
        def __init__(self, raw, maxread):
            self.buf = io.BytesIO(raw)
            self.maxread = maxread

        def read(self, n):
            return self.buf.read(min(n, self.maxread))

    # 70_001-byte short reads: odd chunk lengths, so nearly every row AND
    # batch boundary lands mid-'aa'-pair
    monkeypatch.setattr(
        sys, "stdin", type("S", (), {"buffer": ShortStdin(data, 70_001)})()
    )
    mp = tmp_path / "m.txt"
    mp.write_text("97 97\n")
    op1 = tmp_path / "shard.bin"
    run_tokenizer(CoreConfig.new_from_cli(
        input=None, output=op1, merges=mp, engine=Engine.SHARD))

    ip = tmp_path / "in.bin"
    ip.write_bytes(data)
    op2 = tmp_path / "host.bin"
    run_tokenizer(CoreConfig.new_from_cli(
        input=ip, output=op2, merges=mp, engine=Engine.NUMPY))
    assert op1.read_bytes() == op2.read_bytes()
