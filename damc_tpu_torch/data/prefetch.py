"""Host-side background batch prefetch (the port's copy of
`damc_tpu/data/prefetch.py`).

The C++ batch engine overlaps batch assembly with the device's work on its
own threads, but the NumPy `Loader` (the path of float stores and lazy LSUN
views, whose batches decode JPEGs) makes each batch inside the training
loop. `Prefetcher` moves any batch iterator onto a daemon thread with a
small bounded queue, so the next batch is made while the card runs the
current one.

An exception from the producer reaches the consumer at its next `__next__`,
and again at every later call (the end state is latched); `close()` (or
the context manager, or garbage collection) stops the thread promptly even
when the queue is full. The producer thread holds only the queue, the stop
event and the iterator, never the Prefetcher itself, so an abandoned
Prefetcher is collectable and its `__del__` shuts the thread down on the
exception paths that skip `close()`.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _End:
    pass


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _put(q: queue.Queue, stop: threading.Event, item) -> bool:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _fill(q: queue.Queue, stop: threading.Event, it: Iterator) -> None:
    # Module-level on purpose: a bound method would make the running Thread
    # keep the Prefetcher reachable, defeating __del__-based cleanup.
    try:
        for item in it:
            if not _put(q, stop, item):
                return
        _put(q, stop, _End())
    except BaseException as e:  # surfaced to the consumer
        _put(q, stop, _Error(e))


class Prefetcher:
    """Wrap an iterable so items are produced on a background thread."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._terminal = None  # latched _End or _Error
        self._thread = threading.Thread(
            target=_fill, args=(self._queue, self._stop, iter(iterable)), daemon=True
        )
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        # Poll (rather than block indefinitely) so a close() racing with a
        # consumer already inside get() still terminates: the stopped
        # producer exits without enqueuing _End, and close() may drain the
        # queue out from under us.
        while self._terminal is None:
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    # Non-clobbering: a concurrent close() may have just
                    # latched a drained producer _Error.
                    if self._terminal is None:
                        self._terminal = _End()
                    break
                continue
            if isinstance(item, (_End, _Error)):
                self._terminal = item
            else:
                return item
        if isinstance(self._terminal, _Error):
            raise self._terminal.exc
        raise StopIteration

    def close(self) -> None:
        self._stop.set()
        # Drain so a producer blocked on put() sees the stop event. A
        # pending producer _Error found while draining is latched in
        # preference to the close-induced _End: discarding it would make a
        # dead loader look like a cleanly exhausted stream to any later
        # __next__, breaking the module docstring's propagation guarantee.
        # (A consumer concurrently inside get() cannot block forever either
        # way — __next__ polls with a timeout and checks the stop event.)
        err = None
        try:
            while True:
                item = self._queue.get_nowait()
                if isinstance(item, _Error):
                    err = item
        except queue.Empty:
            pass
        if err is not None:
            self._terminal = err
        elif self._terminal is None:
            self._terminal = _End()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
