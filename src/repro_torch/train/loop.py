"""Online-training orchestrator, the paper's §3 training job (port of
``repro/train/loop.py``).

"Training jobs are separate deployments that automatically query for
relevant chunks of data, download, update based on existing weights and
send the weights to the serving layer." :class:`OnlineTrainer` is a
:class:`~repro_torch.train.pipeline.TrainingPipeline` whose row-delta
frames (§6) are off by default, keeping the classic full/patch wire
behaviour; ``RoundReport.round`` is the frame's version stamp.
"""
from __future__ import annotations

from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike
from repro_torch.train.pipeline import RoundReport, TrainingPipeline  # noqa: F401

__all__ = ["OnlineTrainer", "RoundReport"]


class OnlineTrainer(TrainingPipeline):
    def __init__(self, cfg: FFMConfig, model: str = "deepffm", lr: float = 0.1,
                 transfer_mode: str = "patch+quant", seed: int = 0,
                 device: DeviceLike = None, **kw):
        kw.setdefault("delta_updates", False)
        super().__init__(cfg, model, backend="jit", lr=lr,
                         transfer_mode=transfer_mode, seed=seed,
                         device=device, **kw)
