"""chameleon-34b [vlm] — early-fusion, VQ image tokens. [arXiv:2405.09818]

The vision frontend is the VQ-GAN tokenizer (stub): image content arrives as
discrete token ids inside the 65536 vocab, so the backbone is a dense decoder
with qk-norm (Chameleon's stability fix).

A copy of ``repro/configs/chameleon_34b.py``; weights are random, made from a
seed (``models.registry.init_params``).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b",
        family="vlm",
        source="arXiv:2405.09818",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
        act="swiglu",
        rope_theta=10_000.0,
        fsdp=False,
        attn_chunk_q=1024,
        attn_chunk_k=4096,
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
        fsdp=False,
        remat=False,
    )
