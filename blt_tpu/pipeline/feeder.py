"""Async host<->device pipeline stages (the device feeder).

The reference's L1/L2 is an async mmap -> worker-pool -> ordered-writer
pipeline (reference: blt_core/src/pipeline.rs:56-131, io_handler.rs:51-76).
Its device replacement decomposes a device tokenization run into three
overlapped stages, each on its own thread with bounded hand-off queues:

  stage A (feed):   pack chunk into a host batch, upload, dispatch the
                    device program (serial carry chaining is natural
                    because the stage is single-threaded)
  stage B (drain):  device->host transfer of finished batches + host
                    assembly of the wire stream
  stage C (write):  the runner's ordered writer thread

End-to-end throughput is then max(stage) instead of sum(stage): upload of
batch N+1 overlaps compute of batch N and the drain of batch N-1.
``prefetch_iter`` is the single building block — it runs any generator on a
worker thread with a bounded queue and exact exception propagation, so a
pipeline is just function composition:

    yield from prefetch_iter(drain_gen(prefetch_iter(feed_gen(chunks))))
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()

class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iter(it: Iterable[T], depth: int = 2, name: str = "feeder") -> Iterator[T]:
    """Run ``it`` on a worker thread, yielding up to ``depth`` items ahead.

    Exceptions raised by the source re-raise at the consumer exactly once,
    at the position they occurred (never silently truncating the stream).
    If the consumer abandons the iterator early (generator close), the
    worker is unblocked and exits.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    abandoned = threading.Event()

    def worker() -> None:
        try:
            src = iter(it)
            while True:
                try:
                    item = next(src)
                except StopIteration:
                    break
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            item = _Failure(e)
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue
            return
        while not abandoned.is_set():
            try:
                q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, name=f"blt-{name}", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        abandoned.set()


def pack_into(dst, src, threads: int = 0) -> None:
    """Copy ``src`` bytes into the head of ``dst`` (reused padded buffer).

    Uses the native multithreaded copy when built (the host-bandwidth
    analog of the reference's mmap zero-copy feed, io_handler.rs:54-56);
    tail bytes beyond len(src) are left stale — every device program masks
    by explicit length, so no memset is needed.
    """
    import os

    from blt_tpu import native

    n = src.shape[0]
    if n == 0:
        return
    if native.available() and n >= (1 << 22):
        native.copy_into(src, dst, threads if threads > 0 else (os.cpu_count() or 1))
    else:
        dst[:n] = src
