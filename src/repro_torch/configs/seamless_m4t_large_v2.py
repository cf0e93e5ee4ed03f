"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone. [arXiv:2308.11596]

A copy of ``repro/configs/seamless_m4t_large_v2.py``; weights are random,
made from a seed (``models.registry.init_params``). The mel-spectrogram +
conv feature extractor is the allowed stub: the encoder takes precomputed
(B, S_src, d_model) frame embeddings. 24 encoder + 24 decoder layers (model
card), ReLU FFN (paper §4.3's sparse update trick applies), LayerNorm.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="seamless-m4t-large-v2",
        family="encdec",
        source="arXiv:2308.11596",
        n_layers=24,  # decoder
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        act="relu",
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        vocab_pad_multiple=8,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
