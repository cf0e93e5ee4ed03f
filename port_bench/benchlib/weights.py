"""Weights made from ``--seed`` on the device, in the type they are served
in (float32), with one ``torch.Generator`` and one large draw a leaf.

The scales are those of a trained model rather than of an initializer: the
LR weights and the head's last layer are not zero, so that every part of
the model moves the logit and a fault in any of them shows. The same seed
gives the same weights on the same device, so the reference can make them
again after the program has been freed.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

EMB_STD = 0.05
LR_STD = 0.05
LR_BIAS = -1.0


def leaf_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Leaf path -> shape: the parameter tree of ``cfg["model"]``."""
    f, v, k = cfg["n_fields"], cfg["hash_space"], cfg["k"]
    shapes = {"ffm/emb": (v, f, k), "lr/w": (v,), "lr/b": ()}
    if cfg["model"] == "deepffm":
        d = (f * (f - 1) // 2 + 1,) + tuple(cfg["mlp_hidden"]) + (1,)
        shapes["merge_scale"] = (d[0],)
        shapes["merge_bias"] = (d[0],)
        for i in range(len(d) - 1):
            shapes[f"mlp/w{i}"] = (d[i], d[i + 1])
            shapes[f"mlp/b{i}"] = (d[i + 1],)
    return shapes


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat ``{path: float32 tensor}`` on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for path, shape in sorted(leaf_shapes(cfg).items()):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        if path == "ffm/emb":
            x.mul_(EMB_STD)
        elif path == "lr/w":
            x.mul_(LR_STD)
        elif path == "lr/b":
            x.mul_(0.1).add_(LR_BIAS)
        elif path == "merge_scale":
            x.mul_(0.1).add_(1.0)
        elif path.startswith("mlp/w"):
            x.mul_(1.0 / math.sqrt(shape[0]))
        else:  # merge_bias, mlp biases
            x.mul_(0.1)
        out[path] = x
    return out


def as_tree(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``: the program's params tree."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


def flat_leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`as_tree`."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat_leaves(val, path + "/"))
        else:
            out[path] = val
    return out
