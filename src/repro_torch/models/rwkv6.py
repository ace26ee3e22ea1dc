"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token/time mixing.

Counterpart of ``repro.models.rwkv6``.  Time-mix per head (head size
N = 64):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (matrix state, K x V)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with *data-dependent* per-channel decay w_t = exp(-exp(ww + lora(x_t))) and
token-shift ddlerp mixing.  Prefill runs the recurrence on the WKV6 kernel
(``kernels/rwkv6_scan``) from a zero state and returns the final state; the
JAX model runs its own chunked jnp scan there (the kernel and that scan
agree, ``tests/test_kernels.py``).  Decode is one token against the
(B, H, N, N) fp32 state, in plain torch ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan import ops as wkv_ops
from .config import ModelConfig
from .layers import dense_init

HEAD_N = 64          # RWKV-6 head size
CHUNK = 16           # the JAX model's chunk length (its fp32 exp range)
LOG_W_MIN = -2.5     # per-token decay clamp (w >= e^-2.5)
LORA_R = 32


def n_heads(cfg: ModelConfig) -> int:
    if cfg.d_model % HEAD_N:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the "
                         f"{HEAD_N} head size")
    return cfg.d_model // HEAD_N


def _full(shape, value, generator):
    return torch.full(shape, value, dtype=torch.float32,
                      device=generator.device)


def init_time_mix(generator, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "mu": _full((5, d), 0.5, generator),      # r,k,v,w,g ddlerp base
        "lora_a": 0.01 * dense_init((d, LORA_R * 5), generator),
        "lora_b": 0.01 * dense_init((5, LORA_R, d), generator, in_axis=1),
        "wr": dense_init((d, d), generator),
        "wk": dense_init((d, d), generator),
        "wv": dense_init((d, d), generator),
        "wg": dense_init((d, d), generator),
        "wo": dense_init((d, d), generator),
        "ww": _full((d,), -0.6, generator),       # decay base
        "w_lora_a": 0.01 * dense_init((d, LORA_R), generator),
        "w_lora_b": 0.01 * dense_init((LORA_R, d), generator),
        "u": 0.1 * dense_init((d,), generator),   # bonus
        "ln_scale": _full((d,), 1.0, generator),  # group-norm on heads
    }


def init_channel_mix(generator, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": _full((d,), 0.5, generator),
        "mu_r": _full((d,), 0.5, generator),
        "wk": dense_init((d, ff), generator),
        "wv": dense_init((ff, d), generator),
        "wr": dense_init((d, d), generator),
    }


def _ddlerp(p, x, x_prev, dtype):
    """Data-dependent token-shift mixing -> the 5 mixed inputs (r,k,v,w,g)."""
    xx = x_prev - x                                          # (B, S, D)
    coarse = x + xx * p["mu"][:, None, None, :].to(dtype)    # (5, B, S, D)
    lora = torch.tanh((x + 0.5 * xx) @ p["lora_a"].to(dtype))
    lora = lora.reshape(*x.shape[:-1], 5, LORA_R)
    delta = torch.einsum("bsfr,frd->fbsd", lora, p["lora_b"].to(dtype))
    return coarse + xx * delta


def _decay(p, xw, dtype):
    """Per-token per-channel log decay (fp32), clamped as in JAX."""
    lo = torch.tanh(xw @ p["w_lora_a"].to(dtype)) @ p["w_lora_b"].to(dtype)
    log_w = -torch.exp((p["ww"] + lo.to(torch.float32)).clamp(-8.0, 1.0))
    return log_w.clamp(LOG_W_MIN, -1e-4)                     # (B, S, D)


def _group_norm(p, o, h):
    """Per-head LayerNorm on the (..., H, N) output, flattened to H*N."""
    of = o.to(torch.float32)
    mean = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    of = (of - mean) * torch.rsqrt(var + 64e-5)
    return of.reshape(*of.shape[:-2], h * HEAD_N) * p["ln_scale"]


def time_mix_forward(p, x, x_prev_last, cfg: ModelConfig):
    """x: (B, S, D), any S.  Returns (out, (S_state (B, H, N, N) fp32,
    last_x (B, D))): the recurrence runs on the WKV6 kernel from a zero
    state."""
    dtype = x.dtype
    b, s, _ = x.shape
    h = n_heads(cfg)
    x_prev = torch.cat([x_prev_last[:, None], x[:, :-1]], 1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev, dtype)
    r = (xr @ p["wr"].to(dtype)).reshape(b, s, h, HEAD_N)
    k = (xk @ p["wk"].to(dtype)).reshape(b, s, h, HEAD_N)
    v = (xv @ p["wv"].to(dtype)).reshape(b, s, h, HEAD_N)
    g = F.silu(xg @ p["wg"].to(dtype))
    log_w = _decay(p, xw, dtype).reshape(b, s, h, HEAD_N)
    u = p["u"].reshape(h, HEAD_N)
    # (B, S, H, N) read in place as (B, H, S, N) views; o.transpose(1, 2)
    # is the contiguous (B, S, H, N) output
    o, S_fin = wkv_ops.wkv6(r.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), log_w.transpose(1, 2), u)
    o = _group_norm(p, o.transpose(1, 2), h).to(dtype) * g
    return o @ p["wo"].to(dtype), (S_fin, x[:, -1])


def time_mix_decode(p, x, state, cfg: ModelConfig):
    """x: (B, 1, D); state = (S (B, H, N, N) fp32, last_x (B, D)).
    Returns (out (B, 1, D), (S_new, x[:, 0]))."""
    dtype = x.dtype
    S, last_x = state
    b = x.shape[0]
    h = n_heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, last_x[:, None], dtype)
    r = (xr @ p["wr"].to(dtype)).reshape(b, h, HEAD_N).to(torch.float32)
    k = (xk @ p["wk"].to(dtype)).reshape(b, h, HEAD_N).to(torch.float32)
    v = (xv @ p["wv"].to(dtype)).reshape(b, h, HEAD_N).to(torch.float32)
    g = F.silu(xg @ p["wg"].to(dtype))[:, 0]
    w = torch.exp(_decay(p, xw, dtype).reshape(b, h, HEAD_N))
    u = p["u"].reshape(h, HEAD_N)
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhn,bhnm->bhm", r, S + u[None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    o = _group_norm(p, o, h)                                  # (B, H*N)
    out = (o.to(dtype) * g) @ p["wo"].to(dtype)
    return out[:, None], (S_new, x[:, 0])


def _channel_mix(p, x, xx):
    dtype = x.dtype
    xk = x + xx * p["mu_k"].to(dtype)
    xr = x + xx * p["mu_r"].to(dtype)
    kk = torch.square(torch.relu(xk @ p["wk"].to(dtype)))
    return torch.sigmoid(xr @ p["wr"].to(dtype)) * (kk @ p["wv"].to(dtype))


def channel_mix_forward(p, x, x_prev_last):
    """x: (B, S, D) -> (out, last_x (B, D))."""
    x_prev = torch.cat([x_prev_last[:, None], x[:, :-1]], 1)
    return _channel_mix(p, x, x_prev - x), x[:, -1]


def channel_mix_decode(p, x, last_x):
    """x: (B, 1, D) -> (out (B, 1, D), x[:, 0])."""
    return _channel_mix(p, x, last_x[:, None] - x), x[:, 0]
