"""On-disk checkpointing of training weights and optimizer state (port of
``repro/checkpoint/store.py``).

The paper's first storage win: optimizer state "is not required for actual
inference, which immediately reduces the required space by half" — so
:func:`save` writes weights and optimizer state as separate files and the
serving side only ever fetches the weights file. The files are those of
the JAX package (``checkpoint/layout.py``'s bytes and manifest), so a
checkpoint written by one package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

from repro_torch.checkpoint import layout
from repro_torch.common.device import DeviceLike


def _write(path: str, name: str, tree) -> None:
    buf, manifest = layout.to_bytes(tree)
    with open(os.path.join(path, f"{name}.bin"), "wb") as f:
        f.write(buf)
    with open(os.path.join(path, f"{name}.json"), "w") as f:
        f.write(json.dumps(manifest))


def _read(path: str, name: str, like, device: DeviceLike):
    with open(os.path.join(path, f"{name}.bin"), "rb") as f:
        buf = f.read()
    with open(os.path.join(path, f"{name}.json")) as f:
        manifest = json.load(f)
    return layout.from_bytes(buf, manifest, like=like, device=device)


def save(path: str, params, opt_state=None) -> None:
    os.makedirs(path, exist_ok=True)
    _write(path, "weights", params)
    if opt_state is not None:
        _write(path, "optimizer", opt_state)


def load(path: str, like_params=None, like_opt=None,
         device: DeviceLike = None) -> Tuple[Any, Optional[Any]]:
    """-> (params, optimizer state or ``None``) on ``device`` (``None``:
    the card); with ``like_*`` trees, restructured into them."""
    params = _read(path, "weights", like_params, device)
    opt_state = None
    if os.path.exists(os.path.join(path, "optimizer.bin")):
        opt_state = _read(path, "optimizer", like_opt, device)
    return params, opt_state
