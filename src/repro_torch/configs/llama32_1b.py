"""llama3.2-1b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B]

A copy of ``repro/configs/llama32_1b.py``; weights are random, made from a
seed (``models.registry.init_params``)."""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3.2-1b",
        family="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        act="swiglu",
        rope_theta=500_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
