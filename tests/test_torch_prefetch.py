"""The port's prefetcher stall counters (``PrefetchStats``,
``fetch_stall_fraction``) against the JAX package's on the CPU: the same
batches counted, wait and producer times non-negative and consistent with
the wall clock, the stall fraction JAX's formula."""
import time

import pytest

from repro.data.prefetch import PrefetchStats as JPrefetchStats
from repro.data.prefetch import Prefetcher as JPrefetcher
from repro.data.prefetch import fetch_stall_fraction as j_fetch_stall_fraction
from repro_torch.data.prefetch import (PrefetchStats, Prefetcher,
                                       fetch_stall_fraction)


def _slow_source(n, delay):
    for i in range(n):
        time.sleep(delay)
        yield i


@pytest.mark.parametrize("n,delay,work", [(12, 0.004, 0.0), (8, 0.0, 0.003)])
def test_stall_counters_match_jax(n, delay, work):
    """A slow producer stalls the consumer, a slow consumer does not; both
    prefetchers count the same batches and keep their times consistent."""
    runs = {}
    for name, cls, frac in (("port", Prefetcher, fetch_stall_fraction),
                            ("jax", JPrefetcher, j_fetch_stall_fraction)):
        t0 = time.perf_counter()
        pf = cls(_slow_source(n, delay), depth=4)
        items = []
        for item in pf:
            items.append(item)
            time.sleep(work)
        total = time.perf_counter() - t0
        st = pf.stats
        assert items == list(range(n))
        assert st.batches == n
        assert 0.0 <= st.consumer_wait_s <= total
        assert 0.0 <= st.producer_time_s <= total
        assert frac(total, st) == st.consumer_wait_s / total
        runs[name] = (st, frac(total, st), total)
    (ours, f_ours, _), (ref, f_ref, _) = runs["port"], runs["jax"]
    assert ours.batches == ref.batches
    if delay:  # the producer sets the pace: both consumers mostly wait
        assert f_ours > 0.3 and f_ref > 0.3
        assert ours.producer_time_s >= n * delay * 0.9


def test_stats_and_fraction_equal_jax_on_the_same_numbers():
    ours = PrefetchStats(batches=7, consumer_wait_s=0.25, producer_time_s=1.5)
    ref = JPrefetchStats(batches=7, consumer_wait_s=0.25, producer_time_s=1.5)
    assert ours.__dict__ == ref.__dict__
    for total in (1.0, 3.7, 0.0):
        assert fetch_stall_fraction(total, ours) == \
            j_fetch_stall_fraction(total, ref)
    assert PrefetchStats().__dict__ == JPrefetchStats().__dict__
