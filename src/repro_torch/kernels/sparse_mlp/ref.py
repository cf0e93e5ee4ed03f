"""Plain PyTorch version of the block-skip weight-gradient kernel (port of
``repro/kernels/sparse_mlp/ref.py``)."""
from __future__ import annotations

import torch


def sparse_weight_grad_ref(x: torch.Tensor, g_masked: torch.Tensor
                           ) -> torch.Tensor:
    """(B, I), (B, J) -> (I, J) f32 ``dW = xᵀ · g_masked``."""
    return torch.einsum("bi,bj->ij", x.to(torch.float32),
                        g_masked.to(torch.float32))
