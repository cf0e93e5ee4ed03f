"""Parameter and FLOP accounting (a copy of ``repro/common/counting.py``).

MODEL_FLOPS follows the standard 6·N·D training estimate (2·N·D for a
forward-only step), with N = active parameter count (MoE: shared + top_k
routed experts only). ``chip_smoke.py`` divides ``model_flops(cfg, B·S,
"forward")`` by a prefill's time to print its achieved TFLOP/s.
"""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        q_in = cfg.q_lora_rank or d
        p = 0
        if cfg.q_lora_rank:
            p += d * cfg.q_lora_rank
        p += q_in * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)  # kv down + shared rope key
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        p += cfg.n_heads * cfg.v_head_dim * d  # out proj
        return p
    p = d * cfg.n_heads * hd  # q
    p += 2 * d * cfg.n_kv_heads * hd  # k, v
    p += cfg.n_heads * hd * d  # out
    if cfg.qkv_bias:
        p += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return p


def _ffn_params(cfg, d_ff: int) -> int:
    mult = 3 if cfg.act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _moe_layer_params(cfg, active_only: bool) -> int:
    n_routed = cfg.top_k if active_only else cfg.n_experts
    p = cfg.d_model * cfg.n_experts  # router (always fully held)
    p += n_routed * _ffn_params(cfg, cfg.d_ff_expert or cfg.d_ff)
    p += cfg.n_shared_experts * _ffn_params(cfg, cfg.d_ff_expert or cfg.d_ff)
    return p


def _ssm_layer_params(cfg) -> int:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    p = d * (2 * di + 2 * g * n + h)  # in_proj -> [z, x, B, C, dt]
    p += cfg.d_conv * (di + 2 * g * n)  # conv over x,B,C
    p += 3 * h  # A_log, D, dt_bias
    p += di  # gated norm
    p += di * d  # out proj
    return p


def param_count(cfg, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.padded_vocab * d
    total = emb if cfg.tie_embeddings else 2 * emb

    def dense_layer():
        return _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * dense_layer()
    elif cfg.family == "moe":
        per = _attn_params(cfg) + _moe_layer_params(cfg, active_only) + 2 * d
        total += cfg.n_layers * per
    elif cfg.family == "ssm":
        total += cfg.n_layers * (_ssm_layer_params(cfg) + d)
    elif cfg.family == "hybrid":
        n_attn_pos = cfg.n_layers // cfg.attn_period if cfg.attn_period else 0
        n_mamba = cfg.n_layers - n_attn_pos
        total += n_mamba * (_ssm_layer_params(cfg) + d)
        # shared attn block counted once (weight-tied) + per-occurrence LoRA
        shared = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d
        shared += 2 * d * d  # input concat projection (2d -> d)
        total += shared
        if cfg.lora_rank:
            total += n_attn_pos * 2 * cfg.lora_rank * d
    elif cfg.family == "encdec":
        enc = cfg.n_enc_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d)
        cross = _attn_params(cfg) + d
        dec = cfg.n_layers * (_attn_params(cfg) + cross + _ffn_params(cfg, cfg.d_ff) + 3 * d)
        total += enc + dec
    else:
        raise ValueError(cfg.family)
    return int(total)


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """6·N_active·D for training, 2·N_active·D for inference-forward."""
    n = param_count(cfg, active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
