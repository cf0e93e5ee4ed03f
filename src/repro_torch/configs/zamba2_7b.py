"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242]

A copy of ``repro/configs/zamba2_7b.py``; weights are random, made from a
seed (``models.registry.init_params``). 81 layer positions with the
weight-shared attention block applied every 6th position (13 occurrences,
each with its own LoRA on the concat projection); the remaining 68
positions are Mamba2 blocks (``models/hybrid.py``). The shared block's 32
heads are 3584 / 32 = 112 wide, a head dim kernel K11 takes in both bodies.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,  # -> 112 SSD heads
        ssm_ngroups=1,
        d_conv=4,
        ssm_chunk=256,
        attn_period=6,
        lora_rank=128,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=7,  # 2 super-blocks (period 3) + 1 tail mamba
        attn_period=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        ssm_state=16,
        ssm_headdim=32,
        ssm_chunk=16,
        lora_rank=8,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
