"""mamba2-130m [ssm] — SSD (state-space duality). [arXiv:2405.21060]

A copy of ``repro/configs/mamba2_130m.py``; weights are random, made from a
seed (``models.registry.init_params``). 24 Mamba2 blocks of d_model 768,
inner width 1536 in 24 SSD heads of 64, state size 128, one (B, C) group,
a causal conv of width 4 and chunks of 256 (``models/ssm.py``); no
attention.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=24,
        d_model=768,
        n_heads=0,  # attention-free
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,  # -> 24 SSD heads
        ssm_ngroups=1,
        d_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
        vocab_pad_multiple=1024,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=128,
        ssm_state=32,
        ssm_headdim=32,  # -> 8 heads
        ssm_chunk=16,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
