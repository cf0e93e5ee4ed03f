"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434]

A copy of ``repro/configs/deepseek_v2_236b.py``; weights are random, made
from a seed (``models.registry.init_params``). Multi-head latent attention
(``models/attention.py``: the expanded forward through kernel K11 at qk /
v head dims 192 / 128, the absorbed decode over a latent cache of rank 512
plus one 64-wide rope key) and an MoE FFN whose two shared experts run on
every token beside the routed top-6 of 160 (``models/moe.py``).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        d_ff_expert=1536,
        vocab_size=102400,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        attn_kind="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        act="swiglu",
        fsdp=True,  # 236B total params
        remat_policy="nothing",
        attn_chunk_q=1024,
        attn_chunk_k=4096,
        capacity_factor=1.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        d_ff_expert=128,
        n_experts=4,
        top_k=2,
        n_shared_experts=1,
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        fsdp=False,
        remat=False,
        moe_impl="dense",
    )
