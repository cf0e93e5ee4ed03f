"""granite-8b [dense] — llama-arch, code. [arXiv:2405.04324]

A copy of ``repro/configs/granite_8b.py``; weights are random, made from a
seed (``models.registry.init_params``)."""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-8b",
        family="dense",
        source="arXiv:2405.04324",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        act="swiglu",
        rope_theta=10_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
