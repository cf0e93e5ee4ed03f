"""The controls: the reference put in the program's place and computed in
a lower precision than the configuration states. A comparison that cannot
tell a control from the program cannot tell a later PR's lower precision
either."""
from __future__ import annotations

from typing import Dict


def control_args(control: str) -> Dict:
    """Keyword arguments of the reference functions for one control:
    ``tf32`` (float32 products in TF32) or ``bf16`` (everything in
    bfloat16)."""
    import torch

    if control == "tf32":
        return {"tf32": True}
    if control == "bf16":
        return {"dtype": torch.bfloat16}
    raise ValueError(f"unknown control {control!r}")
