"""Analytic FLOP / HBM-byte accounting per (architecture x shape) cell
(counterpart of ``repro.analysis.flops``: plain arithmetic on
``ModelConfig``, equal to the JAX package's in every field).

Why analytic: XLA's ``compiled.cost_analysis()`` counts while-loop *bodies
once*, and every layer stack of the JAX package is a ``lax.scan`` -- so raw
HLO numbers under-count by ~L x.  The formulas come from the model
definition and were validated against an unrolled tiny config's
``cost_analysis`` (``tests/test_analysis.py``); the port's
``repro_torch.obs.profile.ProfiledFn.capture_cost`` counts executed
operations and is held to them the same way.

Conventions: 1 MAC = 2 FLOPs.  ``TRAIN_MULT`` = 1 fwd + 2 bwd + 1 remat
recompute of the scanned blocks.  Capacity-factor MoE counts dispatched
slots (dropped tokens still occupy capacity).  Attention pair counts: causal
S^2/2, local-window S*w - w^2/2, bidirectional S_q*S_k.
"""
from __future__ import annotations

import dataclasses
import math

from ..launch.shapes import Shape
from ..models.config import ModelConfig
from ..models.layers import MOE_GROUP

TRAIN_MULT_MATMUL = 4.0   # fwd + bwd(2x) + remat fwd recompute
FWD_ONLY = 1.0


@dataclasses.dataclass
class CellCost:
    flops: float              # total FLOPs per step (global, all devices)
    model_flops: float        # 6*N*D (dense) / 6*N_active*D (MoE) for train,
                              # 2*N*D for inference shapes
    hbm_bytes: float          # global HBM traffic per step (see notes)
    notes: dict


def _attn_pairs(kind: str, s_q: int, s_k: int, window: int = 0) -> float:
    if kind == "causal":
        return s_q * s_q / 2.0
    if kind == "local":
        w = min(window, s_q)
        return s_q * w - w * w / 2.0
    return float(s_q) * s_k     # bidir / cross


def _layer_matmul_params(cfg: ModelConfig) -> dict:
    """Per-layer weight-matmul parameter counts by kind."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    out = {}
    out["attn_proj"] = d * nq + 2 * d * nkv + nq * d
    out["mlp"] = (2 if cfg.mlp_type == "gelu" else 3) * d * ff
    if cfg.is_moe:
        out["router"] = d * cfg.n_experts
    if cfg.rwkv:
        out["attn_proj"] = 0
        out["tm"] = 5 * d * d + d * (32 * 5) * 2 + d * 32 * 2
        out["mlp"] = 2 * d * ff + d * d
    return out


def _moe_group(cfg: ModelConfig, b: int, s: int) -> int:
    """Mirror of moe_forward's grouping."""
    if s >= MOE_GROUP and s % MOE_GROUP == 0:
        return MOE_GROUP
    if s == 1:
        return b
    return s


def _moe_expert_flops(cfg: ModelConfig, tokens: float, group: int,
                      mult: float) -> float:
    """Expert FFN + grouped dispatch/combine einsum FLOPs."""
    d, ff = cfg.d_model, cfg.d_ff
    cap = max(4, math.ceil(group * cfg.top_k * cfg.capacity_factor
                           / cfg.n_experts))
    slots = (tokens / group) * cfg.n_experts * cap
    expert = 2 * slots * 3 * d * ff
    # dispatch 'bgd,bgec->becd' + combine: E*C*D*G MACs per group each
    dispatch = 2 * 2 * tokens * cfg.n_experts * cap * d
    return (expert + dispatch) * mult


def _rglru_layout(cfg: ModelConfig):
    span = cfg.rec_per_attn + 1
    n_attn = cfg.n_layers // span
    n_rec = cfg.n_layers - n_attn
    return n_rec, n_attn


def cell_flops(cfg: ModelConfig, shape: Shape) -> CellCost:
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    ctx = shape.seq_len                      # kv length for decode
    if cfg.n_image_tokens and shape.kind == "train":
        s = shape.seq_len                    # image+text total stays seq_len
    tokens = float(b) * s
    mult = TRAIN_MULT_MATMUL if shape.kind == "train" else FWD_ONLY
    hd = cfg.head_dim
    d = cfg.d_model
    lm = _layer_matmul_params(cfg)
    notes = {}

    total = 0.0
    # ---- per-layer projections + mixers -----------------------------------
    if cfg.rwkv:
        per_layer = 2 * tokens * (lm["tm"] + lm["mlp"])
        # WKV6 state math: per token per head: 2*N*N MAC-ish terms (o and S)
        h = d // 64
        state = tokens * h * (4 * 64 * 64)
        total += cfg.n_layers * (per_layer + 2 * state) * mult
    elif cfg.rglru:
        n_rec, n_attn = _rglru_layout(cfg)
        w = cfg.lru_width
        rec_proj = 2 * tokens * (2 * d * w + 2 * w * w + w * d + lm["mlp"])
        rec_state = tokens * w * 12            # gates, scan combine, conv
        attn_proj = 2 * tokens * (lm["attn_proj"] + lm["mlp"])
        if shape.kind == "decode":
            pairs = float(min(cfg.window, ctx)) * b
        else:
            pairs = b * _attn_pairs("local", s, s, cfg.window)
        attn_mix = 4 * pairs * cfg.n_heads * hd
        total += (n_rec * (rec_proj + rec_state)
                  + n_attn * (attn_proj + attn_mix)) * mult
    else:
        per_layer = 2 * tokens * (lm["attn_proj"]
                                  + (0 if cfg.is_moe else lm["mlp"]))
        if shape.kind == "decode":
            pairs = float(ctx) * b
        else:
            pairs = b * _attn_pairs("causal", s, s)
        attn_mix = 4 * pairs * cfg.n_heads * hd
        total += cfg.n_layers * (per_layer + attn_mix) * mult
        if cfg.is_moe:
            group = _moe_group(cfg, b, s)
            total += cfg.n_layers * (
                _moe_expert_flops(cfg, tokens, group, mult)
                + 2 * tokens * lm["router"] * mult)
        if cfg.is_encdec:
            enc_tokens = float(b) * cfg.n_frames
            enc = cfg.encoder_layers * (
                2 * enc_tokens * (lm["attn_proj"] + lm["mlp"])
                + 4 * b * _attn_pairs("bidir", cfg.n_frames, cfg.n_frames)
                * cfg.n_heads * hd)
            # encoder runs once; with remat on train it recomputes once
            total += enc * (2.0 if shape.kind == "train" else 1.0)
            cross_proj = 2 * (tokens + enc_tokens) * (d * cfg.n_heads * hd)
            cross_pairs = b * _attn_pairs("bidir", s, cfg.n_frames) \
                if shape.kind != "decode" else b * float(cfg.n_frames)
            total += cfg.n_layers * (cross_proj * 2
                                     + 4 * cross_pairs * cfg.n_heads * hd) \
                * mult
    # ---- lm head / embedding ----------------------------------------------
    head_tokens = tokens if shape.kind == "train" else float(b)
    total += 2 * head_tokens * d * cfg.vocab_size * \
        (3.0 if shape.kind == "train" else 1.0)  # xent fwd+bwd, no remat

    # ---- MODEL_FLOPS -------------------------------------------------------
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * tokens
    else:
        model_flops = 2.0 * n_active * (tokens if shape.kind == "prefill"
                                        else float(b))

    # ---- HBM bytes (global, per step) --------------------------------------
    p_total = cfg.param_count()
    if shape.kind == "train":
        act_bytes = _activation_bytes(cfg, b, s)
        # params: fwd read + bwd read + grad write/read + opt 6x fp32
        hbm = p_total * 4 * (2 + 2 + 6) + act_bytes
    elif shape.kind == "prefill":
        hbm = p_total * 4 + _activation_bytes(cfg, b, s) / 2
    else:
        hbm = n_active * 4 + _cache_bytes(cfg, b, ctx)
    return CellCost(flops=total, model_flops=model_flops, hbm_bytes=hbm,
                    notes=notes)


def _activation_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    """Stored remat boundaries: one (B,S,D) bf16 per scanned block, written
    once + read once during backward."""
    per_layer = 2.0 * b * s * cfg.d_model * 2
    return cfg.n_layers * per_layer * 2


def _cache_bytes(cfg: ModelConfig, b: int, ctx: int) -> float:
    if cfg.rwkv:
        h = cfg.d_model // 64
        return cfg.n_layers * (b * h * 64 * 64 * 4 + 2 * b * cfg.d_model * 2)
    if cfg.rglru:
        n_rec, n_attn = _rglru_layout(cfg)
        kv = 2 * b * min(cfg.window, ctx) * cfg.n_kv_heads * cfg.head_dim * 2
        st = b * cfg.lru_width * (4 + 2 * (cfg.conv_width - 1))
        return n_attn * kv + n_rec * st
    kv = 2.0 * b * ctx * cfg.n_kv_heads * cfg.head_dim * 2
    total = cfg.n_layers * kv
    if cfg.is_encdec:
        total += cfg.n_layers * 2.0 * b * cfg.n_frames * \
            cfg.n_kv_heads * cfg.head_dim * 2
    return total
