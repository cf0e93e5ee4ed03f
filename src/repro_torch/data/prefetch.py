"""Async data pre-fetching (paper §4.1; a copy of ``repro/data/prefetch.py``).

"By implementing async learning cycles, multiple rounds of 'future' data can
be downloaded upfront, making sure the learning engine has constant influx of
data" — up to 4x faster warm-up. A background thread keeps a bounded queue of
ready batches; the consumer's blocking time is tracked
(:class:`PrefetchStats`), so a caller can report the fetch-stall fraction
(:func:`fetch_stall_fraction`; ``chip_smoke.py``'s training phase prints a
round's).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional


@dataclass
class PrefetchStats:
    batches: int = 0
    consumer_wait_s: float = 0.0
    producer_time_s: float = 0.0


class Prefetcher:
    """Wraps an iterator; a daemon thread fills a bounded queue ahead of use."""

    _SENTINEL = object()

    def __init__(self, it: Iterable[Any], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stats = PrefetchStats()
        # producer-side failure, latched for the consumer: without it a
        # raising source iterator would kill the daemon thread silently and
        # leave __next__ blocked on an empty queue forever
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator[Any]) -> None:
        try:
            while True:
                t0 = time.perf_counter()
                item = next(it)
                self.stats.producer_time_s += time.perf_counter() - t0
                self._q.put(item)
        except StopIteration:
            self._q.put(self._SENTINEL)
        except Exception as e:
            self.error = e
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.stats.consumer_wait_s += time.perf_counter() - t0
        if item is self._SENTINEL:
            self._q.put(self._SENTINEL)  # keep later callers unblocked too
            if self.error is not None:
                raise RuntimeError(
                    "prefetch source iterator failed") from self.error
            raise StopIteration
        self.stats.batches += 1
        return item


def fetch_stall_fraction(total_time_s: float, stats: PrefetchStats) -> float:
    """The share of ``total_time_s`` the consumer spent waiting for data."""
    return stats.consumer_wait_s / max(total_time_s, 1e-9)
