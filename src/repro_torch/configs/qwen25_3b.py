"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B]

A copy of ``repro/configs/qwen25_3b.py``; weights are random, made from a
seed (``models.registry.init_params``)."""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-3b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        act="swiglu",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
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
