"""Device resolution and card description.

Every entry point of the port takes ``device=None``, which means the card.
Without CUDA the caller has to ask for the CPU explicitly; nothing falls
back to it quietly. ``"meta"`` (shapes and dtypes, no memory: the dry run,
``launch/dryrun_lib.py``) is taken only where a caller names it.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for (or implied) and
    absent, so no path goes on on the CPU without the caller saying so.
    ``"meta"`` is taken when named, never implied."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a host
    clock read after it times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def describe(device: DeviceLike = None) -> Dict[str, object]:
    """Name, compute capability and nvidia-smi line of a CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("describe() reports a CUDA device")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {
        "name": torch.cuda.get_device_name(index),
        "capability": torch.cuda.get_device_capability(index),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }
