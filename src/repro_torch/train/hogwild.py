"""Hogwild-based training, paper §4.2, two renditions (port of
``repro/train/hogwild.py``).

1. ``HogwildTrainer`` — threads share mutable weight buffers (tensors on
   the trainer's device: the card unless ``device="cpu"``). Each thread
   computes gradients on a snapshot (a copy) of the buffers and adds
   AdaGrad's *deltas* to them in place, with no lock ("weight
   overlaps/overrides are allowed as the trade-off for multi-threaded
   updates"). On the card every thread enqueues on the same stream, so the
   device runs the threads' work in the order they enqueue it; the race
   Hogwild allows is between a thread's snapshot and its apply, as in the
   JAX package.

2. ``make_local_sgd_round`` — the device analogue: W workers each take k
   steps from the same starting point on their own data, then merge by
   averaging. One merge is one Hogwild "round".

Both draw their update rule from ``optim.adagrad``, the rule the ``jit``
backend applies, and report the pipeline aux (pre-update scores for
progressive validation, §4.3 activation masks), so they plug into
``train.pipeline`` as backends. The gradients take the §4.3 backward
(``deepffm.loss_and_aux``), its weight gradients on the block-skip kernel.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import deepffm
from repro_torch.optim import make_optimizer
from repro_torch.train.pipeline import (_batch_tensors, _flat, _grads,
                                        _leaves_requiring_grad, _unflat,
                                        make_sparse_round_step)


def _copy(tree):
    """A tree of fresh copies of ``tree``'s leaves."""
    return _unflat(tree, iter(t.detach().clone() for t in _flat(tree)))


# ---------------------------------------------------------------------------
# 1. Hogwild: threads over shared buffers
# ---------------------------------------------------------------------------

@dataclass
class HogwildStats:
    examples: int = 0  # guarded-by: lock
    seconds: float = 0.0  # coordinator-only, written after the worker join
    losses: List[float] = field(default_factory=list)  # guarded-by: lock
    labels: List[np.ndarray] = field(default_factory=list)  # guarded-by: lock
    scores: List[np.ndarray] = field(default_factory=list)  # guarded-by: lock
    # per hidden layer: list of (H,) column-alive booleans, one per update
    col_alive: List[List[np.ndarray]] = field(default_factory=list)  # guarded-by: lock

    @property
    def examples_per_s(self) -> float:
        return self.examples / max(self.seconds, 1e-9)

    def merge_batch(self, labels, loss, scores, alive) -> None:  # requires-lock: lock
        """Fold one worker batch in; the caller holds the trainer's stats
        lock — the weights stay Hogwild-free, only the metrics serialize."""
        self.examples += int(labels.shape[0])
        self.losses.append(float(loss))
        self.labels.append(labels)
        self.scores.append(scores)
        if alive:
            if not self.col_alive:
                self.col_alive = [[] for _ in alive]
            for layer, a in zip(self.col_alive, alive):
                layer.append(a)


class HogwildTrainer:
    """§4.2 Hogwild over shared weight buffers on one device.

    ``buffers`` and ``acc`` (AdaGrad's accumulator) are trees of tensors
    that the worker threads update in place; ``params`` (default: the
    model's initial weights from ``seed``) is copied into them.
    """

    def __init__(self, cfg: FFMConfig, model: str = "deepffm",
                 lr: float = 0.05, seed: int = 0, params=None,
                 device: DeviceLike = None):
        self.cfg, self.model = cfg, model
        self.device = resolve_device(device)
        if params is None:
            params = deepffm.init_params(cfg, seed, model, self.device)
        # shared, mutable, lock-free buffers
        self.buffers = _unflat(params, iter(
            t.detach().to(self.device, torch.float32, copy=True)
            for t in _flat(params)))
        self.acc = _unflat(params, iter(torch.zeros_like(t)
                                        for t in _flat(self.buffers)))
        self._opt = make_optimizer("adagrad", lr=lr)

    def _step(self, batch: Dict[str, torch.Tensor]):
        """One worker step: the gradient on a snapshot of the buffers, then
        the lock-free apply. Returns ``(loss, aux)``."""
        var = _leaves_requiring_grad(_copy(self.buffers))
        loss, aux = deepffm.loss_and_aux(self.cfg, var, batch, self.model)
        self._apply(_grads(loss, var))
        return loss.detach(), aux

    @torch.no_grad()
    def _apply(self, grads) -> None:
        """AdaGrad update, in place, no locks — the Hogwild step.

        ``optim.adagrad``'s functional update is evaluated against one read
        (a copy) of the shared buffers and applied as in-place ``+=`` of the
        resulting *deltas*: a row this batch never touched gets a delta of
        exactly 0, so concurrent threads' updates to other rows compose
        instead of being overwritten (writing absolute values back would
        revert what other threads applied since the read). Same-element
        collisions remain the racy read-modify-write the mechanism allows
        by design.
        """
        p0, a0 = _copy(self.buffers), _copy(self.acc)
        new_p, new_state = self._opt.update(grads, {"acc": a0}, p0, 0)
        for buf, acc, p, a, np_, na in zip(
                _flat(self.buffers), _flat(self.acc), _flat(p0), _flat(a0),
                _flat(new_p), _flat(new_state["acc"])):
            acc.add_(na - a)
            buf.add_(np_ - p)

    def train(self, batches: Iterable[Dict[str, Any]],
              n_threads: int = 4) -> HogwildStats:
        """Run ``batches`` (host arrays) through ``n_threads`` workers;
        returns once the device has applied every update."""
        stats = HogwildStats()
        q: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
        lock = threading.Lock()  # only guards the *stats*, never the weights
        errors: List[BaseException] = []

        def worker():
            while True:
                b = q.get()
                if b is None:
                    return
                if errors:
                    continue  # drain, so the feeder never blocks
                try:
                    loss, aux = self._step(_batch_tensors(b, self.device))
                    loss = float(loss)
                    scores = torch.sigmoid(aux["logits"].detach()).cpu().numpy()
                    alive = [m.any(dim=0).cpu().numpy() for m in aux["masks"]]
                except Exception as e:  # re-raised by train() after the join
                    errors.append(e)
                    continue
                with lock:
                    stats.merge_batch(np.asarray(b["label"]), loss, scores,
                                      alive)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        try:
            for b in batches:
                q.put(b)
        finally:
            for _ in threads:
                q.put(None)
            for t in threads:
                t.join()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.seconds = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return stats

    def params(self):
        """The shared weight buffers (updated in place by later rounds)."""
        return self.buffers

    def opt_state(self):
        """AdaGrad state in ``optim.adagrad``'s tree shape."""
        return {"acc": self.acc}


# ---------------------------------------------------------------------------
# 2. Local SGD: W workers from one start, merged by averaging
# ---------------------------------------------------------------------------

def check_workers(workers: int) -> None:
    """The averaging merge leaves W bit-identical untouched rows
    byte-stable only for a power-of-two W; row-delta frames rely on it."""
    if workers < 1 or workers & (workers - 1):
        raise ValueError(f"local_sgd workers must be a power of two, "
                         f"got {workers}")


def _merge(trees: List[Any]):
    """The mean of W power-of-two trees as explicit pairwise halving,
    ``(t[0::2] + t[1::2]) * 0.5`` until one is left: exact for identical
    values at every power of two, whatever order a reduction kernel would
    pick."""
    while len(trees) > 1:
        trees = [_unflat(a, iter((x + y) * 0.5 for x, y in
                                 zip(_flat(a), _flat(b))))
                 for a, b in zip(trees[0::2], trees[1::2])]
    return trees[0]


def make_local_sgd_round(cfg: FFMConfig, model: str, lr: float = 0.05):
    """Returns ``round_fn(params, acc, batches) -> (params, acc, mean_loss,
    aux)``.

    ``batches``: host arrays with leading (W workers, k local steps, batch
    ...) dims. Each worker runs its k steps through
    :func:`~repro_torch.train.pipeline.make_sparse_round_step` (equal to
    the dense AdaGrad step) from its own copy of ``(params, acc)``; the
    workers run one after another, then merge. ``params`` and ``acc`` are
    left as they were. ``aux`` carries the pre-update scores (W, k, B) and
    the per-hidden-layer column-alive masks (W, k, H).
    """
    step = make_sparse_round_step(cfg, model, make_optimizer("adagrad", lr=lr))

    def round_fn(params, acc, batches):
        workers = len(batches["label"])
        check_workers(workers)
        ps, accs, outs = [], [], []
        for w in range(workers):
            p, state, _, out = step(_copy(params), {"acc": _copy(acc)}, 0,
                                    {k: v[w] for k, v in batches.items()})
            ps.append(p)
            accs.append(state["acc"])
            outs.append(out)
        aux = {"scores": torch.stack([o["scores"] for o in outs]),
               "col_alive": [torch.stack(layer) for layer in
                             zip(*(o["col_alive"] for o in outs))]}
        mean_loss = torch.stack([o["loss"] for o in outs]).mean()
        return _merge(ps), _merge(accs), mean_loss, aux

    return round_fn
