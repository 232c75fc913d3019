"""Feeder pipeline primitives: prefetch_iter, pack_into.

These implement the device replacement for the reference's async
chunk pipeline (reference: blt_core/src/pipeline.rs:56-131): bounded
in-flight hand-off with exact ordering and error propagation.
"""

import threading
import time

import numpy as np
import pytest

from blt_tpu.pipeline.feeder import pack_into, prefetch_iter


def test_prefetch_preserves_order():
    items = list(range(100))
    assert list(prefetch_iter(iter(items), depth=3)) == items


def test_prefetch_propagates_exception_at_position():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_bounded_depth():
    """The source never runs more than depth items ahead of the consumer
    (the reference's bounded in-flight tasks, pipeline.rs:85-101)."""
    produced = []
    consumed = threading.Event()

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    it = prefetch_iter(gen(), depth=2)
    next(it)
    time.sleep(0.3)  # let the worker run as far ahead as it can
    # 1 consumed + up to 2 queued + 1 blocked in put
    assert len(produced) <= 5
    assert list(it) == list(range(1, 50))
    consumed.set()


def test_prefetch_early_abandon_unblocks_worker():
    done = threading.Event()

    def gen():
        try:
            for i in range(10_000):
                yield i
        finally:
            done.set()

    it = prefetch_iter(gen(), depth=1)
    assert next(it) == 0
    it.close()  # abandon; worker must exit, not deadlock
    # worker exits after noticing abandonment (bounded wait)
    for _ in range(50):
        if done.is_set():
            break
        time.sleep(0.1)
    # The generator may not run its finally (daemon thread parked in put),
    # but the thread must not hold the queue lock; a fresh iterator works.
    assert list(prefetch_iter(iter([1, 2]), depth=1)) == [1, 2]


@pytest.mark.parametrize("n", [0, 5, 1 << 22, (1 << 22) + 13])
def test_pack_into_exact(n):
    rng = np.random.default_rng(n % 97)
    src = rng.integers(0, 256, n, dtype=np.uint8)
    dst = np.full(max(n, 1) + 64, 0xEE, np.uint8)
    pack_into(dst, src, threads=4)
    assert np.array_equal(dst[:n], src)
    assert (dst[n:] == 0xEE).all()  # tail untouched
