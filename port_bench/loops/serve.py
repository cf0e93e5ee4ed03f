"""Serving loop: closed-loop clients around one ``InferenceEngine``.

Every client is a thread that hands its next call (a list of requests) to
``InferenceEngine.score_batch`` as soon as its last one returns; all
clients share the engine. Client ``c`` takes calls ``c``, ``c + C``, ...
of the pool, wrapping. A request's latency runs from the moment its
client hands the call over to the moment the results come back, so every
request of a call has the call's latency.

Set-up makes the weights on the device, builds the engine (which derives
its int8 tables), makes the traffic pool and runs the mix's warm-up calls
through the clients, so every bucket the mix uses has run once. Calls that
complete inside the window count; a call still running at the close does
not. The results of a sample of the pool's calls (every ``SAMPLE_EVERY``-th
call from an offset drawn from the seed) are kept as returned, and after
the window the reference scores the same rows.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchlib import traffic
from benchlib.controls import control_args
from benchlib.program import ffm_config
from benchlib.runner import Window, log
from benchlib.trace import TRIES
from benchlib.weights import as_tree, make_weights

CHECK_ROWS = 1 << 16  # rows the reference scores after the window
SAMPLE_EVERY = 16     # the kept calls: one in this many of the pool
TRACE_SECONDS = 2.0   # the traced part of a window: the profiler's volume


class Loop:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.mix = cell.config, cell.mix

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from repro_torch.kernels import _build
        from repro_torch.serving.engine import InferenceEngine

        if self.device != "cpu":
            _build.load()  # the kernel library: built once per checkout
        log("kernel library loaded")
        c = self.cfg
        params = as_tree(make_weights(c, self.seed, self.device))
        self.engine = InferenceEngine(
            ffm_config(c), c["model"], params=params, device=self.device,
            quantized=c["quantized"], fused=c["fused"],
            host_gather=c["host_gather"], prefix_stride=c["prefix_stride"],
            cache_entries=c["cache_entries"], dedup=c["dedup"],
            parallel=c["parallel"])
        del params
        log("engine built (int8 tables derived)")
        self.pool = traffic.make_serve_pool(c, self.mix, self.seed,
                                            self.device)
        log("traffic pool made")
        self.sample_at = int(traffic.rng_for(self.seed, 6).integers(
            SAMPLE_EVERY))
        threads, _, _, errors = self._clients(
            self.pool.warmup, time.perf_counter() + 3600.0, keep=False)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if self.device != "cpu":
            torch.cuda.synchronize()
        log("warm-up calls done")

    # -- the window -----------------------------------------------------------
    def _counters(self) -> Dict[str, float]:
        e = self.engine
        s = e.stats
        return {"requests": s.requests, "predictions": s.candidates,
                "rows_scored": s.rows_scored,
                "ctx_tail_fields": s.ctx_tail_fields,
                "hits": e.hits, "misses": e.misses}

    def _clients(self, calls: List, t_end: float, keep: bool):
        """Run the closed loop over ``calls`` until ``t_end`` (or, for the
        warm-up, until each call has run once). Returns per-call records
        (start, end, requests, predictions, failed) and kept results."""
        n_clients = int(self.mix["clients"])
        records: List[List] = [[] for _ in range(n_clients)]
        kept: Dict[int, List[np.ndarray]] = {}
        errors: List[BaseException] = []
        once = not keep
        start = threading.Barrier(n_clients + 1)

        def client(c: int) -> None:
            start.wait()
            i = c
            while True:
                if once and i >= len(calls):
                    return
                if time.perf_counter() >= t_end:
                    return
                j = i % len(calls)
                reqs = calls[j]
                n_pred = sum(r[2].shape[0] for r in reqs)
                t0 = time.perf_counter()
                try:
                    out = self.engine.score_batch(reqs)
                    ok = True
                except Exception as e:  # a failed call counts as failed
                    errors.append(e)
                    ok = False
                t1 = time.perf_counter()
                records[c].append((t0, t1, len(reqs), n_pred, not ok, j))
                if (keep and ok and j % SAMPLE_EVERY == self.sample_at
                        and j not in kept and t1 <= t_end):
                    kept[j] = out
                i += n_clients

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"bench-client-{c}")
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        start.wait()
        return threads, records, kept, errors

    def measure(self, seconds: float, tracer) -> Window:
        t0 = time.perf_counter()
        t_end = t0 + seconds
        before = self._counters()
        threads, records, kept, errors = self._clients(self.pool.calls, t_end,
                                                       keep=True)
        traced: Dict[str, float] = {}
        if tracer is not None:
            # a traced part from the window's first third on; a session
            # that lost its kernels gives way to the next part
            span = min(TRACE_SECONDS, seconds / (3 * TRIES))
            time.sleep(max(0.0, t0 + seconds / 3 - time.perf_counter()))
            for _ in range(TRIES):
                a = self._counters()
                tracer.start()
                time.sleep(span)
                recorded = tracer.stop()
                b = self._counters()
                if recorded:
                    break
            traced = {k: b[k] - a[k] for k in a}
        time.sleep(max(0.0, t_end - time.perf_counter()))
        after = self._counters()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not finish its last call")
        self.kept = kept
        if errors:
            log(f"{len(errors)} call(s) failed; the first: {errors[0]!r}")
        done = [r for rs in records for r in rs if r[1] <= t_end]
        ok = [r for r in done if not r[4]]
        lat = np.repeat([(r[1] - r[0]) * 1e3 for r in ok],
                        [r[2] for r in ok])
        e2e = {"predictions_per_s": sum(r[3] for r in ok) / seconds,
               "request_p95_ms": float(np.percentile(lat, 95))
               if lat.size else float("nan")}
        counters = {k: after[k] - before[k] for k in before}
        counters["calls"] = len(ok)
        return Window(e2e, counters, traced,
                      attempted=sum(r[2] for r in done),
                      failed=sum(r[2] for r in done if r[4]), seconds=seconds)

    def release(self) -> None:
        self.engine.close()
        del self.engine

    # -- the comparison -------------------------------------------------------
    def _rows(self):
        """Full rows (idx, val) of the kept calls, and the served logits,
        call by call in pool order until ``CHECK_ROWS``."""
        idx, val, served = [], [], []
        n = 0
        for j in sorted(self.kept):
            for (ci, cv, ki, kv), out in zip(self.pool.calls[j],
                                             self.kept[j]):
                m = ki.shape[0]
                idx.append(np.concatenate([np.broadcast_to(ci, (m, ci.size)),
                                           ki], axis=1))
                val.append(np.concatenate([np.broadcast_to(cv, (m, cv.size)),
                                           kv], axis=1))
                served.append(np.asarray(out, np.float32))
                n += m
            if n >= CHECK_ROWS:
                break
        return (np.concatenate(idx), np.concatenate(val),
                np.concatenate(served))

    def check(self, control: Optional[str]) -> Dict[str, float]:
        from reference import deepffm_ref as ref

        if not self.kept:
            return {"logit_gap": float("inf")}
        idx, val, served = self._rows()
        c = self.cfg
        w = make_weights(c, self.seed, self.device)
        want = ref.serve_logits(c, w, idx, val)
        if control is not None:
            served = ref.serve_logits(c, w, idx, val, **control_args(control))
        return {"logit_gap": float(np.max(np.abs(served - want)))}

