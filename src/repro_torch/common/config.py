"""Configuration of the port (copies of ``repro/common/config.py``'s
``ModelConfig``, ``InputShape`` with its four shapes, and ``FFMConfig``).

Each copy is kept field for field equal to the JAX package's dataclass; a
test holds them together. ``ModelConfig.param_count`` is the analytic
count of ``common/counting.py`` (``pspec.count`` counts a spec tree); the
SSM properties (``d_inner``, ``n_ssm_heads``) are there for its ``ssm`` and
``hybrid`` branches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.common import counting


@dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""  # citation for the config

    # transformer core
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"  # swiglu | relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # attention variant
    attn_kind: str = "gqa"  # gqa | mla
    attn_chunk_q: int = 512   # flash-attention query-chunk length
    attn_chunk_k: int = 1024  # flash-attention kv-chunk length
    kv_cache_dtype: str = "native"  # native | int8 (paper-§6 quantization applied to the decode cache)
    sliding_window: int = 0  # 0 -> full attention; >0 -> banded
    long_context_window: int = 8192  # window used for the long_500k variant

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "auto"  # dense | expert_parallel | auto
    router_aux_coef: float = 0.01

    # MLA (deepseek-style latent attention)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    d_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style)
    attn_period: int = 0  # every `attn_period`-th block is the shared attn block
    lora_rank: int = 0  # per-occurrence LoRA on the shared block

    # encoder-decoder
    n_enc_layers: int = 0

    # compute / distribution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "dots"  # dots | nothing (full recompute)
    fsdp: bool = False  # additionally shard params over the data axis
    pure_dp: bool = False  # replicate all params (small models: TP is counterproductive)
    seq_shard_acts: bool = False  # Megatron-SP style: saved activations shard S over model
    scan_layers: bool = True
    vocab_pad_multiple: int = 2048

    # ---- derived helpers -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # analytic parameter count (model_flops' N)
    def param_count(self, active_only: bool = False) -> int:
        return counting.param_count(self, active_only=active_only)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


@dataclass(frozen=True)
class FFMConfig:
    """Configuration of the paper's DeepFFM (core contribution).

    Mirrors Fwumious Wabbit: hashed feature space, per-field embeddings of
    width ``k``, LR part, and an MLP head over the merged+normalized LR/FFM
    outputs (paper eq. Dffm).
    """

    n_fields: int = 24
    hash_space: int = 2**18
    k: int = 8  # FFM embedding width
    mlp_hidden: tuple = (64, 32)
    mlp_act: str = "relu"  # ReLU is what makes §4.3 sparse updates possible
    context_fields: int = 16  # first `context_fields` fields are the request context (§5)
    dtype: str = "float32"
    seed: int = 0

    @property
    def n_pairs(self) -> int:
        return self.n_fields * (self.n_fields - 1) // 2

    def replace(self, **kw) -> "FFMConfig":
        return dataclasses.replace(self, **kw)
