"""Async data pre-fetching (paper §4.1; a copy of ``repro/data/prefetch.py``).

"By implementing async learning cycles, multiple rounds of 'future' data can
be downloaded upfront, making sure the learning engine has constant influx of
data" — up to 4x faster warm-up. A background thread keeps a bounded queue of
ready batches. The JAX package's stall timers and ``fetch_stall_fraction``
wait for a port caller that reads them.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional


class Prefetcher:
    """Wraps an iterator; a daemon thread fills a bounded queue ahead of use."""

    _SENTINEL = object()

    def __init__(self, it: Iterable[Any], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        # producer-side failure, latched for the consumer: without it a
        # raising source iterator would kill the daemon thread silently and
        # leave __next__ blocked on an empty queue forever
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                self._q.put(item)
            self._q.put(self._SENTINEL)
        except Exception as e:
            self.error = e
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(self._SENTINEL)  # keep later callers unblocked too
            if self.error is not None:
                raise RuntimeError(
                    "prefetch source iterator failed") from self.error
            raise StopIteration
        return item
