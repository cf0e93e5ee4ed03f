"""The plain reference of the benchmarked models, in PyTorch alone.

  logit = LR(x) + sum of DiagMask'd FFM pairs
          (+ MLP(MergeNorm(LR(x), pairs)) for ``deepffm``)

written from the paper's equations and Fwumious Wabbit's model, with no
kernel, cache, batching, dedup or sparse update: the whole row is scored
from the weights every time, and training differentiates the dense loss
over whole tables with autograd, then applies AdaGrad to every weight.

The served tables are int8; this module derives them again from the
float32 weights the benchmark made (a grid per table row, and per block
of ``lr_block`` LR weights: ``scale = (max - min) / 254``, ``zero = (max
+ min) / 2``, codes rounded half to even and clipped to +-127), and
scores the dequantized rows. It imports nothing of the program.

``dtype`` and ``tf32`` compute it in a lower precision: that is the
benchmark's control, which the comparison must tell apart.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

LEVELS = 255


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matrix products on or off inside, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _grid(mn: torch.Tensor, mx: torch.Tensor):
    # a true division by a tensor: on the card a division by a scalar is
    # a multiplication by its reciprocal, which rounds otherwise
    levels = torch.full_like(mn, LEVELS - 1)
    scale = torch.where(mx > mn, (mx - mn) / levels, torch.ones_like(mn))
    zero = (mn + mx) * np.float32(0.5)
    return scale, zero


def dequant_rows(rows: torch.Tensor) -> torch.Tensor:
    """(R, ...) float32 table rows -> their int8 round trip, a grid a row."""
    flat = rows.reshape(rows.shape[0], -1)
    scale, zero = _grid(flat.amin(1), flat.amax(1))
    codes = torch.clamp(torch.round((flat - zero[:, None]) / scale[:, None]),
                        -127, 127)
    return (codes * scale[:, None] + zero[:, None]).reshape(rows.shape)


def dequant_lr(lr_w: torch.Tensor, idx: torch.Tensor, block: int
               ) -> torch.Tensor:
    """LR weights at ``idx`` after the int8 round trip of their blocks (a
    trailing partial block padded with the vector's last weight)."""
    v = lr_w.numel()
    b = torch.div(idx, block, rounding_mode="floor")
    elems = b[..., None] * block + torch.arange(block, device=idx.device)
    blocks = lr_w[torch.clamp(elems, max=v - 1)]
    scale, zero = _grid(blocks.amin(-1), blocks.amax(-1))
    w = lr_w[idx]
    codes = torch.clamp(torch.round((w - zero) / scale), -127, 127)
    return codes * scale + zero


def pair_index(f: int, device):
    iu = np.triu_indices(f, k=1)
    return (torch.from_numpy(iu[0]).to(device),
            torch.from_numpy(iu[1]).to(device))


def forward(cfg: Dict, w: Dict[str, torch.Tensor], idx: torch.Tensor,
            val: torch.Tensor, *, emb_rows=None, lr_rows=None,
            dtype=torch.float32) -> torch.Tensor:
    """Logits of full rows ``idx`` / ``val`` (B, F). ``emb_rows`` (B, F, F,
    k) and ``lr_rows`` (B, F) replace the plain gathers (the int8 round
    trip). Computed in ``dtype``; returned as float32."""
    f = cfg["n_fields"]
    e = (w["ffm/emb"][idx] if emb_rows is None else emb_rows).to(dtype)
    lw = (w["lr/w"][idx] if lr_rows is None else lr_rows).to(dtype)
    v = val.to(dtype)
    pi, pj = pair_index(f, idx.device)
    # pair (i, j), i < j: <e[i, field j], e[j, field i]> v_i v_j
    dots = (e[:, pi, pj] * e[:, pj, pi]).sum(-1)
    pairs = dots * (v[:, pi] * v[:, pj])
    lr = (lw * v).sum(-1) + w["lr/b"].to(dtype)
    logit = lr + pairs.sum(-1)
    if cfg["model"] == "deepffm":
        z = torch.cat([lr[:, None], pairs], dim=-1)
        mu = z.mean(-1, keepdim=True)
        var = ((z - mu) ** 2).mean(-1, keepdim=True)
        h = (z - mu) / torch.sqrt(var + 1e-6)
        h = h * w["merge_scale"].to(dtype) + w["merge_bias"].to(dtype)
        n = len(cfg["mlp_hidden"]) + 1
        for i in range(n):
            h = h @ w[f"mlp/w{i}"].to(dtype) + w[f"mlp/b{i}"].to(dtype)
            if i < n - 1:
                h = torch.relu(h)
        logit = logit + h[:, 0]
    return logit.to(torch.float32)


def serve_logits(cfg: Dict, w: Dict[str, torch.Tensor], idx: np.ndarray,
                 val: np.ndarray, *, block_rows: int = 8192,
                 dtype=torch.float32, tf32: bool = False) -> np.ndarray:
    """Logits of full rows as the served int8 tables give them, in blocks
    of ``block_rows`` rows so that any number of rows fits."""
    dev = w["ffm/emb"].device
    out = []
    with torch.no_grad(), matmul_precision(tf32):
        for s in range(0, idx.shape[0], block_rows):
            i = torch.from_numpy(np.asarray(idx[s:s + block_rows],
                                            np.int64)).to(dev)
            x = torch.from_numpy(np.asarray(val[s:s + block_rows],
                                            np.float32)).to(dev)
            rows = w["ffm/emb"][i]
            rows = dequant_rows(rows.reshape(-1, *rows.shape[2:])
                                ).reshape(rows.shape)
            lr = dequant_lr(w["lr/w"], i, cfg["lr_block"])
            out.append(forward(cfg, w, i, x, emb_rows=rows, lr_rows=lr,
                               dtype=dtype).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in a form that never overflows."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def train(cfg: Dict, w0: Dict[str, torch.Tensor],
          batches: Sequence[Dict[str, np.ndarray]], lr: float, *,
          eps: float = 1e-10, dtype=torch.float32, tf32: bool = False
          ) -> Dict[str, object]:
    """AdaGrad (accumulator from 0, step ``lr * g / sqrt(acc + eps)``) on
    the dense loss, one step a batch. Returns each step's loss, the first
    step's gradient norm per leaf and the weights after the last step."""
    dev = w0["ffm/emb"].device
    p = {k: t.clone() for k, t in w0.items()}
    acc = {k: torch.zeros_like(t) for k, t in w0.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with matmul_precision(tf32):
        for step, batch in enumerate(batches):
            idx = torch.from_numpy(np.asarray(batch["idx"], np.int64)).to(dev)
            val = torch.from_numpy(batch["val"]).to(dev)
            y = torch.from_numpy(batch["label"]).to(dev)
            var = {k: t.detach().requires_grad_() for k, t in p.items()}
            loss = bce(forward(cfg, var, idx, val, dtype=dtype), y)
            grads = torch.autograd.grad(loss, list(var.values()))
            losses.append(loss.item())
            with torch.no_grad():
                for (k, t), g in zip(var.items(), grads):
                    g = g.to(torch.float32)
                    if step == 0:
                        grad_norms[k] = float(torch.linalg.vector_norm(g))
                    acc[k] += g * g
                    p[k] = t.detach() - lr / torch.sqrt(acc[k] + eps) * g
            del var, grads, loss
    return {"losses": losses, "grad_norms": grad_norms, "params": p}
