"""Native C++ host engine tests (skipped when the .so is not built)."""

import random

import numpy as np
import pytest

from blt_tpu import native
from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_numpy import bpe_encode_flat

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libbltnative.so could not be built"
)


def test_ensure_built_self_builds(tmp_path, monkeypatch):
    """A fresh checkout self-builds the .so on first load, keyed on its
    source: a library built from another source is never loaded."""
    import os
    import shutil

    from blt_tpu.native import build as nb

    out = nb.ensure_built()
    assert out is not None and out == nb.lib_path()
    assert os.path.basename(out).startswith("libbltnative.")
    # a private copy of the source: its own directory, its own key
    src = tmp_path / "feeder.cpp"
    shutil.copy(nb.SRC, src)
    monkeypatch.setattr(nb, "DIR", str(tmp_path))
    monkeypatch.setattr(nb, "SRC", str(src))
    first = nb.ensure_built()
    assert first is not None and first.startswith(str(tmp_path))
    assert nb.ensure_built() == first  # fresh: no rebuild
    # an edited source is a new key: rebuilt, and the stale library removed
    src.write_text(src.read_text() + "\n// edited\n")
    second = nb.ensure_built()
    assert second is not None and second != first
    assert os.path.exists(second) and not os.path.exists(first)
    # BLT_NATIVE_BUILD=0 suppresses building but keeps an existing lib
    monkeypatch.setenv("BLT_NATIVE_BUILD", "0")
    assert nb.ensure_built() == second
    src.write_text(src.read_text() + "// again\n")
    assert nb.ensure_built() is None


def test_widen_be():
    rng = np.random.default_rng(0)
    for n in [0, 1, 7, 8, 9, 100_001]:
        d = rng.integers(0, 256, n, dtype=np.uint8)
        assert native.widen_be(d, 3) == d.astype(">u2").tobytes()


def test_flat_bpe_vs_numpy_with_carries():
    rng = np.random.default_rng(1)
    prng = random.Random(2)
    for _ in range(25):
        merges = {}
        vocab = 256
        for _ in range(prng.randint(1, 20)):
            merges[(prng.randint(97, 101), prng.randint(97, 101))] = vocab
            vocab += 1
        table = MergeTable.build(merges)
        n = prng.randint(2, 40_000)
        data = rng.integers(97, 102, n).astype(np.uint8)
        if prng.random() < 0.3:
            data[: min(n, 2000)] = 97  # adversarial parity run
        expected = bpe_encode_flat(data, table).astype(">u2").tobytes()
        out, _ = native.flat_bpe(data, table.dense, False, -1, prng.choice([1, 4]))
        assert out == expected
        cut = prng.randint(1, n)
        nb = int(data[cut]) if cut < n else -1
        o1, c1 = native.flat_bpe(data[:cut], table.dense, False, nb, 2)
        o2, _ = native.flat_bpe(data[cut:], table.dense, c1, -1, 2)
        assert bytes(o1) + bytes(o2) == expected
