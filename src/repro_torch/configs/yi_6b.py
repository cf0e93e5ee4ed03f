"""yi-6b [dense] — llama-arch GQA. [arXiv:2403.04652]

A copy of ``repro/configs/yi_6b.py``; weights are random, made from a
seed (``models.registry.init_params``)."""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="yi-6b",
        family="dense",
        source="arXiv:2403.04652",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        act="swiglu",
        rope_theta=5_000_000.0,
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
