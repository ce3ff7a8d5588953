"""Input pipeline of the streaming replay: :class:`Prefetcher`, a bounded
background prefetch over any iterator (a
:class:`~repro_torch.data.trace_store.TraceStore`'s chunk windows).

The training loader (``ShardedLoader``, ``make_batch_spec``) comes with
the training slice (ROADMAP Queue A item 14c).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

_DONE = object()


class Prefetcher:
    """Double-buffered background prefetch over any iterator.

    A producer thread pulls items from ``it`` into a bounded queue of
    ``depth`` slots, so the consumer (e.g. a replay chunk loop) overlaps
    the next window's disk read with the current window's compute while
    holding at most ``depth + 1`` items alive — the streaming-replay
    memory bound.  Producer exceptions are re-raised in the consumer at
    the point of ``next()``; ``close()`` stops the producer and drains
    the queue (safe to call twice, and from ``finally``).
    """

    def __init__(self, it, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._buffered = 0
        self.peak_buffered_bytes = 0
        self._thread = threading.Thread(
            target=self._produce, args=(iter(it),), daemon=True)
        self._thread.start()

    @staticmethod
    def _nbytes(item) -> int:
        if isinstance(item, np.ndarray):
            return int(item.nbytes)
        if isinstance(item, dict):
            return sum(Prefetcher._nbytes(v) for v in item.values())
        if isinstance(item, (tuple, list)):
            return sum(Prefetcher._nbytes(v) for v in item)
        return 0

    def _produce(self, it) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                nb = self._nbytes(item)
                with self._lock:
                    self._buffered += nb
                    self.peak_buffered_bytes = max(
                        self.peak_buffered_bytes, self._buffered)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as exc:  # forwarded to the consumer
            self._err = exc
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)  # keep exhaustion idempotent
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        with self._lock:
            self._buffered -= self._nbytes(item)
        return item

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
