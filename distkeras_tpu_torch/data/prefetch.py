"""Background prefetch — overlap host input work with device compute (a
copy of ``distkeras_tpu.data.prefetch`` for the PyTorch port).

:class:`Prefetcher` is a bounded one-thread pipeline that pulls items from
a source iterator and maps a ``prepare`` function (in the port: stack the
window into pinned memory and ``.to(device, non_blocking=True)``) up to
``depth`` items ahead of the consumer. While the card runs window N, the
host thread is already staging window N+1's buffers — double buffering,
since CUDA work is enqueued asynchronously and the copy from pinned memory
overlaps compute.

Order is preserved exactly (single worker thread + FIFO queue), so
trainers keep their bit-identical trajectories with prefetch on or off.
Exceptions in the source/prepare re-raise at the consumption point, and
``close()`` (also called by ``__exit__`` and generator teardown) stops the
thread without draining.
"""

from __future__ import annotations

import queue
import threading

_DONE = object()


class Prefetcher:
    """Iterate ``prepare(item) for item in source`` with a ``depth``-deep
    background pipeline. ``depth=0`` degrades to synchronous mapping."""

    def __init__(self, source, prepare=None, depth: int = 2):
        self._prepare = prepare if prepare is not None else (lambda x: x)
        self._depth = int(depth)
        if self._depth <= 0:
            self._iter = iter(source)
            self._queue = None
            self._thread = None
            return
        self._iter = None
        self._terminal = None  # StopIteration or the propagated exception
        self._queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _fill(self, source):
        try:
            for item in source:
                if self._stop.is_set():
                    return
                out = self._prepare(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
            self._put_forever(_DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised at consumer
            self._put_forever(exc)

    def _put_forever(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._queue is None:  # synchronous fallback
            return self._prepare(next(self._iter))
        if self._terminal is not None:
            # the worker puts its sentinel exactly once and exits; without
            # this latch a second next() after exhaustion/error would block
            # on an empty queue forever
            raise self._terminal
        item = self._queue.get()
        if item is _DONE:
            self._terminal = StopIteration()
            raise self._terminal
        if isinstance(item, BaseException):
            self._terminal = item
            raise item
        return item

    def close(self):
        if self._thread is not None:
            self._stop.set()
            # unblock a put-blocked worker
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
