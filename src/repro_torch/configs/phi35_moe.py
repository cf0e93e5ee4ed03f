"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]

A copy of ``repro/configs/phi35_moe.py``; weights are random, made from a
seed (``models.registry.init_params``)."""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b",
        family="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        d_ff_expert=6400,
        vocab_size=32064,
        n_experts=16,
        top_k=2,
        act="swiglu",
        fsdp=True,  # 42B total params
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        d_ff_expert=256,
        n_experts=4,
        top_k=2,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        fsdp=False,
        remat=False,
        moe_impl="dense",
    )
