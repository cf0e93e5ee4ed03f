"""The program's configuration object, built from a configuration file:
the one place the harness names the port's ``FFMConfig`` fields."""
from __future__ import annotations

from typing import Dict


def ffm_config(cfg: Dict):
    from repro_torch.common.config import FFMConfig

    return FFMConfig(n_fields=cfg["n_fields"], hash_space=cfg["hash_space"],
                     k=cfg["k"], mlp_hidden=tuple(cfg["mlp_hidden"]),
                     mlp_act=cfg["mlp_act"],
                     context_fields=cfg["context_fields"], dtype=cfg["dtype"])
