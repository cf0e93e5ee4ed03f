"""The online-training pipeline, the trainer half of the paper (§3 online
rounds, §4.3 sparse updates, §6 transfer; port of
``repro/train/pipeline.py``).

One :class:`TrainingPipeline` round closes the train->serve loop:

  prefetched ingest (§4.1) -> AdaGrad updates from one of three backends
  (§4.3 ReLU-masked backward, its weight gradients on the block-skip
  kernel) -> touched-row tracking -> a versioned update frame (a row
  **delta** in steady state, §6) for the serving engine.

The backends share the update rule (``optim.adagrad``):

* ``jit``       — the sequential reference: a row-sparse step per
  microbatch (:func:`make_sparse_round_step`).
* ``hogwild``   — §4.2: threads over shared weight buffers on the device
  (``train/hogwild.py:HogwildTrainer``).
* ``local_sgd`` — the device analogue of Hogwild: W workers from one
  start, merged by averaging (``train/hogwild.py:make_local_sgd_round``).

The JAX package runs a ``jit`` round as one jitted ``lax.scan`` with
donated buffers. Here a round is a Python loop of eager microbatch steps
that update the trainer's own tensors in place: the embedding and LR tables and
their accumulators are written only at the rows a microbatch touched. The
step keeps its outputs on the device; the round copies losses, scores and
column-alive masks to the host once. ``torch.unique`` (the touched rows,
whose count sets the shapes that follow) synchronizes once per microbatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store, transfer
from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.metrics import roc_auc
from repro_torch.core import deepffm, ffm, sparse_updates
from repro_torch.data.prefetch import Prefetcher
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import Optimizer

BACKENDS = ("jit", "hogwild", "local_sgd")
PREFETCH_DEPTH = 8  # batches fetched ahead of the trainer

_KIND_NAMES = {transfer.KIND_FULL: "full", transfer.KIND_PATCH: "patch",
               transfer.KIND_DELTA: "delta"}


@dataclass
class RoundReport:
    """One online round, as reported to the deployment's control plane."""

    round: int               # == the update frame's version stamp
    examples: int
    seconds: float
    mean_loss: float
    progressive_auc: float
    update_bytes: int
    examples_per_s: float = 0.0
    skip_stats: Dict[str, float] = field(default_factory=dict)
    touched_rows: int = 0    # unique embedding/LR rows updated this round
    update_kind: str = "full"  # full | patch | delta (| dropped | corrupt)
    update_seconds: float = 0.0  # of ``seconds``: make_update(s)


@dataclass
class RoundMetrics:
    """What a backend hands back from one round of updates (host arrays)."""

    examples: int = 0
    losses: List[float] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    scores: List[np.ndarray] = field(default_factory=list)
    # per hidden layer: (n_updates, H) column-alive booleans (§4.3)
    col_alive: List[np.ndarray] = field(default_factory=list)


def emb_leaf_path(model: str) -> Optional[str]:
    """Manifest path of the row-sparse embedding table, if the model has one."""
    return {"ffm": "ffm/emb", "deepffm": "ffm/emb", "mlp": "emb"}.get(model)


def touched_paths(batches: Iterable[Dict[str, Any]], model: str
                  ) -> Tuple[Dict[str, np.ndarray], int]:
    """Row-sparse leaves -> unique rows updated by ``batches`` (§6 deltas).

    Exact by construction: a hashed feature index receives gradient only
    when it occurs in a batch, and the LR and FFM embedding tables are
    indexed by the same hashes.
    """
    idxs = [np.asarray(b["idx"]).ravel() for b in batches]
    if not idxs:
        return {}, 0
    rows = np.unique(np.concatenate(idxs)).astype(np.int64)
    touched = {"lr/w": rows}
    emb = emb_leaf_path(model)
    if emb is not None:
        touched[emb] = rows
    return touched, int(rows.size)


# ---------------------------------------------------------------------------
# The round steps
# ---------------------------------------------------------------------------

def _flat(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [tree]


def _unflat(like, it):
    if isinstance(like, dict):
        return {k: _unflat(v, it) for k, v in like.items()}
    return next(it)


def _leaves_requiring_grad(tree):
    """The differentiated copy of a tree: each leaf a detached view that
    requires grad (autograd's gradients land on these, not on the trainer's
    tensors)."""
    return _unflat(tree, iter(t.detach().requires_grad_() for t in _flat(tree)))


def _grads(loss: torch.Tensor, var):
    """d loss / d every leaf of ``var`` (zeros where a leaf is unused)."""
    leaves = _flat(var)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return _unflat(var, iter(torch.zeros_like(t) if g is None else g
                             for t, g in zip(leaves, gs)))


def _assign_(dst, src) -> None:
    """Write every leaf of ``src`` into the same leaf of ``dst``, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _assign_(dst[k], src[k])
    else:
        dst.copy_(src)


def _batch_tensors(batches: Dict[str, Any], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """Stacked host batches -> tensors on ``device`` (indices as int64, as
    row gathers and ``index_copy_`` take them)."""
    out = {k: torch.as_tensor(np.asarray(v)).to(device)
           for k, v in batches.items()}
    out["idx"] = out["idx"].to(torch.int64)
    return out


def _outs(loss, aux) -> Dict[str, Any]:
    return {
        "loss": loss.detach(),
        # progressive validation: these logits came from the pre-update
        # params (the very forward the gradient came from)
        "scores": torch.sigmoid(aux["logits"].detach()),
        "col_alive": [m.any(dim=0) for m in aux["masks"]],
    }


def _round_fn(micro):
    """Wrap a microbatch step into ``round_fn(params, opt_state, step,
    batches) -> (params, opt_state, step, outs)``."""

    def round_fn(params, opt_state, step, batches):
        device = _flat(params)[0].device
        stacked = _batch_tensors(batches, device)
        outs = []
        for m in range(stacked["label"].shape[0]):
            outs.append(micro(params, opt_state, step + m,
                              {k: v[m] for k, v in stacked.items()}))
        return params, opt_state, step + len(outs), {
            "loss": torch.stack([o["loss"] for o in outs]),
            "scores": torch.stack([o["scores"] for o in outs]),
            "col_alive": [torch.stack(layer) for layer in
                          zip(*(o["col_alive"] for o in outs))],
        }

    return round_fn


def make_round_step(cfg: FFMConfig, model: str, opt: Optimizer):
    """The *dense* reference step: the full-space gradient (the MLP's
    through the §4.3 backward, as in the sparse step) and AdaGrad update of
    every leaf, per microbatch.

    Returns ``round_fn(params, opt_state, step, batches) -> (params,
    opt_state, step, outs)``. ``batches`` holds arrays with a leading
    microbatch axis M; ``params`` and ``opt_state`` are updated in place
    and returned; ``outs`` holds the per-update losses (M,), pre-update
    scores (M, B) and per-layer column-alive masks (M, H) on the device.
    :func:`make_sparse_round_step` is the production step.
    """

    def micro(params, opt_state, step, batch):
        var = _leaves_requiring_grad(params)
        loss, aux = deepffm.loss_and_aux(cfg, var, batch, model)
        new_params, new_state = opt.update(_grads(loss, var), opt_state,
                                           params, step)
        _assign_(params, new_params)
        _assign_(opt_state, new_state)
        return _outs(loss, aux)

    return _round_fn(micro)


def make_sparse_round_step(cfg: FFMConfig, model: str, opt: Optimizer):
    """The **row-sparse** AdaGrad round step (§4.3, the online-learning
    regime made structural). Per microbatch it

    1. differentiates the *gathered* rows (``emb[idx]``, ``lr_w[idx]``, as
       detached leaves) plus the dense head leaves: autograd never builds a
       gradient of a whole table;
    2. sums the occurrences of each touched row exactly, in a fixed order,
       before AdaGrad squares the sum (:func:`_touched_rows`), so a round
       is reproducible bit for bit;
    3. applies the optimizer's update to the touched rows and the dense
       head, and writes the rows back with ``index_copy_`` (unique rows, so
       the scatter is deterministic).

    An untouched row sees a zero gradient under the dense rule (accumulator
    and weight unchanged), so this is the dense step restricted to the
    touched rows. Same signature and returns as :func:`make_round_step`.
    """
    emb_path = emb_leaf_path(model)
    n_fields, k = cfg.n_fields, cfg.k

    def get_emb(tree):
        return tree["emb"] if model == "mlp" else tree["ffm"]["emb"]

    def local_loss(v, batch, b):
        val = batch["val"]
        lr_out = torch.sum(v["lr_rows"] * val, dim=-1) + v["dense"]["lr_b"]
        if model == "linear":
            return lr_out, []
        if model == "mlp":
            pooled = (v["emb_rows"].mean(dim=2) * val[..., None]).reshape(b, -1)
            mlp_out, masks = deepffm.mlp_apply(
                cfg, v["dense"]["mlp"], pooled, return_masks=True,
                sparse_backward=True)
            return lr_out + mlp_out, masks
        e = v["emb_rows"]
        dots = torch.einsum("bijk,bjik->bij", e, e)
        vv = val[:, :, None] * val[:, None, :]
        pi, pj = ffm.on_device(ffm.pair_indices, (n_fields,), e.device)
        return deepffm.head_from_parts(
            cfg, v["dense"], lr_out, (dots * vv)[:, pi, pj], model,
            with_masks=True, sparse_backward=True)

    def micro(params, opt_state, step, batch):
        acc = opt_state["acc"]
        b, f = batch["idx"].shape
        flat = batch["idx"].reshape(-1)
        lr_w, acc_lr_w = params["lr"]["w"], acc["lr"]["w"]

        # the differentiated leaves: gathered rows + the dense head
        var = {"lr_rows": lr_w[flat].reshape(b, f).requires_grad_(),
               "dense": _leaves_requiring_grad(_dense_subtree(params, model))}
        if emb_path is not None:
            var["emb_rows"] = get_emb(params)[flat].reshape(
                b, f, n_fields, k).requires_grad_()
        logits, masks = local_loss(var, batch, b)
        loss = ffm.bce_loss(logits, batch["label"])
        g = _grads(loss, var)

        # exact row gradients: the occurrences of a row sum first
        rows, row_sums = _touched_rows(flat)

        p_rows = {"lr_w": lr_w[rows]}
        a_rows = {"lr_w": acc_lr_w[rows]}
        g_rows = {"lr_w": row_sums(g["lr_rows"].reshape(-1))}
        if emb_path is not None:
            p_rows["emb"] = get_emb(params)[rows]
            a_rows["emb"] = get_emb(acc)[rows]
            g_rows["emb"] = row_sums(g["emb_rows"].reshape(b * f, n_fields, k))

        # one optimizer application over {touched rows} + {dense head}
        dense_p = _dense_subtree(params, model)
        dense_a = _dense_subtree(acc, model)
        new_p, new_state = opt.update(
            {"rows": g_rows, "dense": g["dense"]},
            {"acc": {"rows": a_rows, "dense": dense_a}},
            {"rows": p_rows, "dense": dense_p}, step)
        new_a = new_state["acc"]

        # write back in place: the touched rows, then the dense head
        lr_w.index_copy_(0, rows, new_p["rows"]["lr_w"])
        acc_lr_w.index_copy_(0, rows, new_a["rows"]["lr_w"])
        if emb_path is not None:
            get_emb(params).index_copy_(0, rows, new_p["rows"]["emb"])
            get_emb(acc).index_copy_(0, rows, new_a["rows"]["emb"])
        _assign_(dense_p, new_p["dense"])
        _assign_(dense_a, new_a["dense"])
        return _outs(loss, {"logits": logits, "masks": masks})

    return _round_fn(micro)


def _touched_rows(flat: torch.Tensor):
    """``flat`` (N,) row ids -> ``(rows, row_sums)``: the sorted unique rows
    and a function that sums per-occurrence values (N, ...) into per-row
    sums (len(rows), ...), each row's occurrences added in batch order.

    On the card that is ``index_put_(accumulate=True)``, which PyTorch runs
    as a stable sort of the ids and an in-order sum per id, with no float
    atomics: the kernel autograd runs for a gather's gradient, so these
    sums equal the dense step's table gradient bit for bit. On the CPU that
    op adds in parallel in no fixed order, so a stable sort and a segment
    sum take its place."""
    rows, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    if flat.is_cuda:
        def row_sums(occ):
            return occ.new_zeros((rows.numel(),) + occ.shape[1:]).index_put_(
                (inv,), occ, accumulate=True)
    else:
        order = torch.argsort(inv, stable=True)

        def row_sums(occ):
            return torch.segment_reduce(occ[order], "sum", lengths=counts,
                                        axis=0, unsafe=True)
    return rows, row_sums


def _dense_subtree(params, model: str) -> Dict[str, Any]:
    """The non-row-sparse leaves of a params/acc tree, as the flat dict the
    sparse step differentiates (``lr_b`` + head leaves); its leaves are the
    tree's own tensors."""
    dense = {"lr_b": params["lr"]["b"]}
    if model in ("mlp", "deepffm"):
        dense["mlp"] = params["mlp"]
    if model == "deepffm":
        dense["merge_scale"] = params["merge_scale"]
        dense["merge_bias"] = params["merge_bias"]
    return dense


# ---------------------------------------------------------------------------
# The backends and the pipeline
# ---------------------------------------------------------------------------

class JitBackend:
    """The sequential reference backend (the JAX package's ``jit``).

    Batches are stacked along a leading microbatch axis per contiguous run
    of identical shapes, and each run goes through
    :func:`make_sparse_round_step`; the run's outputs come to the host in
    one copy.
    """

    def __init__(self, cfg: FFMConfig, model: str, opt: Optimizer):
        self._round = make_sparse_round_step(cfg, model, opt)
        self._step = 0

    @staticmethod
    def _shape_key(b: Dict[str, Any]) -> Tuple:
        return tuple((k, np.asarray(v).shape) for k, v in sorted(b.items()))

    def run(self, params, opt_state, batches):
        m = RoundMetrics()
        i = 0
        while i < len(batches):
            j = i + 1
            key = self._shape_key(batches[i])
            while j < len(batches) and self._shape_key(batches[j]) == key:
                j += 1
            group = batches[i:j]
            stacked = {k: np.stack([np.asarray(b[k]) for b in group])
                       for k in group[0]}
            params, opt_state, self._step, outs = self._round(
                params, opt_state, self._step, stacked)
            m.losses.extend(outs["loss"].cpu().numpy().tolist())
            m.scores.append(outs["scores"].cpu().numpy().reshape(-1))
            m.labels.append(stacked["label"].reshape(-1))
            alive = [a.cpu().numpy() for a in outs["col_alive"]]
            if not m.col_alive:
                m.col_alive = alive
            else:
                m.col_alive = [np.concatenate([c, a])
                               for c, a in zip(m.col_alive, alive)]
            m.examples += int(stacked["label"].size)
            i = j
        return params, opt_state, m


class HogwildBackend:
    """§4.2 Hogwild as a pipeline backend: a
    :class:`~repro_torch.train.hogwild.HogwildTrainer` (threads over shared
    buffers on the device, racy by design), made from the first round's
    params; its buffers are the pipeline's params from then on."""

    def __init__(self, cfg: FFMConfig, model: str, *, lr: float,
                 n_threads: int, device: torch.device):
        self.cfg, self.model, self.lr = cfg, model, lr
        self.n_threads, self.device = n_threads, device
        self._trainer = None

    def run(self, params, opt_state, batches):
        from repro_torch.train import hogwild

        if self._trainer is None:
            self._trainer = hogwild.HogwildTrainer(
                self.cfg, self.model, lr=self.lr, params=params,
                device=self.device)
        stats = self._trainer.train(batches, n_threads=self.n_threads)
        m = RoundMetrics(examples=stats.examples, losses=list(stats.losses),
                         labels=list(stats.labels), scores=list(stats.scores))
        if stats.col_alive:
            m.col_alive = [np.stack(layer) for layer in stats.col_alive]
        return self._trainer.params(), self._trainer.opt_state(), m


class LocalSGDBackend:
    """The device analogue of Hogwild: W workers each take k AdaGrad steps
    from the same starting point, then merge by averaging — one merge per
    round (``train/hogwild.py:make_local_sgd_round``).

    ``workers`` must be a power of two: averaging W bit-identical untouched
    rows is then exact, which the row-delta frames rely on (untouched rows
    must stay byte-stable).
    """

    def __init__(self, cfg: FFMConfig, model: str, *, lr: float,
                 workers: int):
        from repro_torch.train import hogwild

        hogwild.check_workers(workers)
        self.workers = workers
        self._round = hogwild.make_local_sgd_round(cfg, model, lr=lr)

    def run(self, params, opt_state, batches):
        w = self.workers
        key = JitBackend._shape_key(batches[0]) if batches else None
        usable = [b for b in batches if JitBackend._shape_key(b) == key]
        k = len(usable) // w
        if k < 1:
            raise ValueError(
                f"local_sgd round needs >= {w} same-shape batches, got "
                f"{len(usable)} matching the first batch's shape "
                f"(of {len(batches)} total)")
        usable = usable[: w * k]
        stacked = {
            kk: np.stack([np.stack([np.asarray(b[kk])
                                    for b in usable[wi * k:(wi + 1) * k]])
                          for wi in range(w)])
            for kk in usable[0]
        }
        params, acc, loss, aux = self._round(params, opt_state["acc"], stacked)
        m = RoundMetrics(examples=int(stacked["label"].size))
        m.losses.append(float(loss))
        m.scores.append(aux["scores"].cpu().numpy().reshape(-1))
        m.labels.append(stacked["label"].reshape(-1))
        m.col_alive = [a.cpu().numpy().reshape(-1, a.shape[-1])
                       for a in aux["col_alive"]]
        return params, {"acc": acc}, m


class TrainingPipeline:
    """The paper's §3 online-training job: rounds in, update frames out.

    ``run_round`` consumes one round's batches (through the §4.1
    prefetcher), trains on them, and emits the versioned update blob for
    the serving layer — a ``KIND_DELTA`` row-delta frame in steady state
    when ``delta_updates`` is on (the trainer knows which embedding and LR
    rows it touched), full or patch framing on the first round or after a
    regrid.

    ``device=None`` means the card (weights, optimizer state, the step and
    the sender's quantization all run there); pass ``device="cpu"`` for the
    plain versions of the kernels. The ``jit`` and ``hogwild`` backends
    update ``params`` and ``opt_state`` in place; ``local_sgd`` replaces
    them with the merge each round. ``hogwild_threads`` and
    ``local_sgd_workers`` size those two backends.

    ``shard_ranges`` (a fleet topology's contiguous row ranges) turns the
    update channel into a fan-out: ``run_round`` returns one frame per shard
    (:class:`~repro_torch.checkpoint.transfer.ShardedSender`, shard order)
    instead of one full-space frame.
    """

    def __init__(self, cfg: FFMConfig, model: str = "deepffm",
                 backend: str = "jit", *, lr: float = 0.1,
                 transfer_mode: str = "patch+quant",
                 delta_updates: bool = True, seed: int = 0,
                 hogwild_threads: int = 4, local_sgd_workers: int = 2,
                 device: DeviceLike = None, shard_ranges=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.cfg, self.model, self.lr = cfg, model, lr
        self.backend_name = backend
        self.delta_updates = delta_updates
        self.device = resolve_device(device)
        self.params = deepffm.init_params(cfg, seed, model, self.device)
        self.opt = make_optimizer("adagrad", lr=lr)
        self.opt_state = self.opt.init(self.params)
        if shard_ranges is not None:
            row_paths = sorted({"lr/w"} | ({emb_leaf_path(model)}
                                           if emb_leaf_path(model) else set()))
            self.sender = transfer.ShardedSender(
                ranges=shard_ranges, row_paths=row_paths, mode=transfer_mode,
                device=self.device)
            # publish the wire layout now, so sender.manifests configures the
            # fleet's decode pipes before the first round
            self.sender.prime(self.params)
        else:
            self.sender = transfer.Sender(mode=transfer_mode,
                                          device=self.device)
        self.reports: List[RoundReport] = []
        if backend == "jit":
            self.backend = JitBackend(cfg, model, self.opt)
        elif backend == "hogwild":
            self.backend = HogwildBackend(cfg, model, lr=lr,
                                          n_threads=hogwild_threads,
                                          device=self.device)
        else:
            self.backend = LocalSGDBackend(cfg, model, lr=lr,
                                           workers=local_sgd_workers)

    @property
    def acc(self):
        """The AdaGrad accumulator."""
        return self.opt_state["acc"]

    def run_round(self, batches: Iterable[Dict[str, Any]]):
        """One online round; returns the versioned update frame, or the
        per-shard ``List[bytes]`` (shard order) of a fan-out pipeline."""
        t0 = time.perf_counter()
        batch_list = list(Prefetcher(batches, depth=PREFETCH_DEPTH))
        self.params, self.opt_state, m = self.backend.run(
            self.params, self.opt_state, batch_list)
        touched, n_rows = (touched_paths(batch_list, self.model)
                           if self.delta_updates else (None, 0))
        # report.round and the frame's version stamp are the same number:
        # the serving engine tracks it as weights_version
        version = len(self.reports) + 1
        t1 = time.perf_counter()
        if isinstance(self.sender, transfer.ShardedSender):
            # one frame per shard, one version stamp on all; a fault plan
            # may drop or mangle a frame: the report counts the surviving
            # frames' bytes and the kind of the first that decodes
            update = self.sender.make_updates(self.params, version=version,
                                              touched=touched or None)
            shipped = [u for u in update if u is not None]
            update_bytes = sum(len(u) for u in shipped)
            kind = "dropped"
            for u in shipped:
                try:
                    kind = _KIND_NAMES[transfer.unframe(u).kind]
                    break
                except transfer.FrameError:
                    kind = "corrupt"
        else:
            update = self.sender.make_update(self.params, version=version,
                                             touched=touched or None)
            update_bytes = len(update)
            kind = _KIND_NAMES[transfer.unframe(update).kind]
        t2 = time.perf_counter()
        skip = (sparse_updates.skip_stats_from_col_alive(m.col_alive)
                if m.col_alive else {})
        self.reports.append(RoundReport(
            round=version, examples=m.examples, seconds=t2 - t0,
            mean_loss=float(np.mean(m.losses)) if m.losses else float("nan"),
            progressive_auc=roc_auc(np.concatenate(m.labels),
                                    np.concatenate(m.scores))
            if m.labels else 0.5,
            update_bytes=update_bytes,
            examples_per_s=m.examples / max(t2 - t0, 1e-9),
            skip_stats=skip, touched_rows=n_rows,
            update_kind=kind,
            update_seconds=t2 - t1,
        ))
        return update

    def checkpoint(self, path: str) -> None:
        store.save(path, self.params, {"acc": self.acc})
