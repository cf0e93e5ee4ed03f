"""Online-training loop: ``TrainingPipeline.run_round`` back to back.

Set-up builds the one pipeline the window uses, puts the benchmark's
weights into it, and drives it through its first steps with the window's
own call and feed, on pool microbatches that all differ: a round of one
microbatch (the first step, and a full frame), then a full round of
``microbatches_per_round`` microbatches, as every round of the window is
(its steps, and the row-delta frame over all of them). What the
comparison needs of them is read there and kept: each round's mean loss,
each leaf's gradient norm from the AdaGrad accumulator after the first
step, the norm of each leaf's change after the last, and both frames.
The first step's numbers are steady from seed to seed; the full round's
carry the round-off of 33 steps, which this model's first AdaGrad step
(every touched weight moved by about ``lr``) amplifies, so they are
compared apart.

The window runs rounds of ``microbatches_per_round`` microbatches,
cycling through the pool; each round ends in one update frame, kept in
memory and dropped. The window holds whole rounds: it closes with the
frame of the round under way once ``--seconds`` have passed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from benchlib import traffic
from benchlib.controls import control_args
from benchlib.program import ffm_config
from benchlib.runner import Window, log
from benchlib.trace import TRIES
from benchlib.weights import flat_leaves, leaf_shapes, make_weights

def _norm(t) -> float:
    import torch
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def gap(prog: Dict[str, float], want: Dict[str, float],
        leaves: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = sorted(want) if leaves is None else leaves
    med = float(np.median([want[k] for k in want]))
    return max(abs(prog[k] - want[k]) / max(want[k], med) for k in leaves)


class Loop:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.mix = cell.config, cell.mix

    def setup(self) -> None:
        import torch
        from repro_torch.kernels import _build
        from repro_torch.train.pipeline import TrainingPipeline

        if self.device != "cpu":
            _build.load()
        c = self.cfg
        self.pipe = TrainingPipeline(
            ffm_config(c), c["model"], c["backend"], lr=c["lr"],
            transfer_mode=c["transfer_mode"], delta_updates=c["delta_updates"],
            device=self.device)
        w0 = make_weights(c, self.seed, self.device)
        mine = flat_leaves(self.pipe.params)
        if sorted(mine) != sorted(w0):
            raise RuntimeError(f"the pipeline's leaves {sorted(mine)} are "
                               f"not the configuration's {sorted(w0)}")
        with torch.no_grad():
            for k, t in mine.items():
                t.copy_(w0[k])
        log("pipeline built, weights in")
        self.pool = traffic.make_train_pool(c, self.mix, self.seed,
                                            self.device)
        log("traffic pool made")
        self.per_round = int(self.mix["microbatches_per_round"])
        self.rounds = [[self.pool[0]], self.pool[1:1 + self.per_round]]
        self.frames = [self.pipe.run_round(self.rounds[0])]
        acc = flat_leaves(self.pipe.acc)
        self.grad_norms = {k: float(torch.sqrt(torch.sum(
            a.to(torch.float64)))) for k, a in acc.items()}
        self.frames.append(self.pipe.run_round(self.rounds[1]))
        log(f"set-up steps done: 1, then a round of {self.per_round}")
        self.losses = [r.mean_loss for r in self.pipe.reports]
        now = flat_leaves(self.pipe.params)
        self.change_norms = {k: _norm(now[k] - w0[k]) for k in w0}
        del w0, now, mine, acc
        # the full round ran the window's shapes already
        self.cursor = 1 + self.per_round
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _round(self):
        n = len(self.pool)
        batches = [self.pool[(self.cursor + i) % n]
                   for i in range(self.per_round)]
        self.cursor = (self.cursor + self.per_round) % n
        self.pipe.run_round(batches)  # the frame is made and dropped
        return self.pipe.reports[-1]

    def measure(self, seconds: float, tracer) -> Window:
        """Whole rounds, until ``seconds`` have passed: the window ends
        with the frame of the round running at ``seconds``, and the rate
        is all of its examples over all of its time."""
        t0 = time.perf_counter()
        rounds = []
        traced: Dict[str, float] = {}
        recorded = False
        while not rounds or time.perf_counter() - t0 < seconds:
            # the first round traced; a session that lost its kernels
            # gives way to the next round
            tracing = (tracer is not None and not recorded
                       and len(rounds) < TRIES)
            if tracing:
                tracer.start()
            rounds.append(self._round())
            if tracing:
                recorded = tracer.stop()
                traced = {"examples": rounds[-1].examples,
                          "microbatches": self.per_round}
        window = time.perf_counter() - t0
        examples = sum(r.examples for r in rounds)
        counters = {"rounds": len(rounds), "examples": examples,
                    "microbatches": len(rounds) * self.per_round,
                    "step_seconds": sum(r.seconds - r.update_seconds
                                        for r in rounds),
                    "update_seconds": sum(r.update_seconds for r in rounds),
                    "update_bytes": sum(r.update_bytes for r in rounds)}
        return Window({"examples_per_s": examples / window}, counters,
                      traced, attempted=examples, failed=0,
                      seconds=window)

    def release(self) -> None:
        del self.pipe

    def check(self, control: Optional[str]) -> Dict[str, float]:
        import torch
        from benchlib import wire
        from reference import deepffm_ref as ref

        c = self.cfg
        w0 = make_weights(c, self.seed, self.device)
        batches = [b for r in self.rounds for b in r]
        ends = np.cumsum([len(r) for r in self.rounds])

        def round_means(losses):
            return [float(np.mean(losses[a:b]))
                    for a, b in zip([0, *ends[:-1]], ends)]

        want = ref.train(c, w0, batches, c["lr"])
        want_change = {k: _norm(want["params"][k] - w0[k]) for k in w0}
        del want["params"]
        # leaves the reference hardly moves (a gradient under a thousandth
        # of the median leaf's) move under AdaGrad by round-off alone
        med = float(np.median(list(want["grad_norms"].values())))
        moved = sorted(k for k, g in want["grad_norms"].items()
                       if g >= 1e-3 * med)
        if control is None:
            losses, grads, change = (self.losses, self.grad_norms,
                                     self.change_norms)
            dec = wire.Decoder()
            for f in self.frames:
                dec.apply(f)
            got = wire.split_leaves(dec.weights(), leaf_shapes(c))
            frame_change = {k: _norm(torch.from_numpy(got[k]).to(
                self.device) - w0[k]) for k in w0}
        else:
            if control == "half_batch":  # a fault: half of each batch left out
                low = ref.train(c, w0, [{k: v[:v.shape[0] // 2]
                                         for k, v in b.items()}
                                        for b in batches], c["lr"])
            else:
                low = ref.train(c, w0, batches, c["lr"],
                                **control_args(control))
            losses, grads = round_means(low["losses"]), low["grad_norms"]
            change = {k: _norm(low["params"][k] - w0[k]) for k in w0}
        rounds = round_means(want["losses"])
        out = {
            # the first step: steady from seed to seed
            "loss_gap": abs(losses[0] - rounds[0]) / abs(rounds[0]),
            "grad_gap": gap(grads, want["grad_norms"]),
            # the full round: its 32 steps carry the round-off of every
            # step before (PERF.md), so these read wider
            "round_loss_gap": abs(losses[1] - rounds[1]) / abs(rounds[1]),
            "change_gap": gap(change, want_change, moved),
        }
        if control is None:
            out["frame_gap"] = gap(frame_change, want_change, moved)
        return out
