"""Model primitives: norms, rotary, GQA attention, MLP.

Counterpart of ``repro.models.layers`` for the families the port serves
(olmo-1b, rwkv6-3b, recurrentgemma-2b).  Parameters are plain dicts of
tensors; compute runs in the input's dtype with fp32 softmax and
normalisation.  Layouts at the public functions are the JAX package's:
activations ``(B, S, D)``, q/k/v ``(B, S, H, D)``, caches
``(B, S_cache, KV, D)``.  Causal and local (sliding-window) prefill
attention run on the flash attention kernel, and under autograd (training)
its gradient on the flash-attention backward kernel; one-token decode
attention is plain torch ops (the JAX package has no kernel there either).
Every op is differentiable: weights are cast to the compute dtype at each
use (``.to(dtype)``), so training keeps fp32 parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa_ops
from .config import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, in_axis: int = 0):
    """Truncated normal on [-2, 2] scaled by ``1/sqrt(fan_in)``, fp32, on
    the generator's device."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return w.mul_(1.0 / math.sqrt(shape[in_axis]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: int):
    if cfg.norm_type in ("rmsnorm", "layernorm"):
        p = {"scale": torch.ones((d,), dtype=torch.float32)}
        if cfg.norm_type == "layernorm" and cfg.use_bias:
            p["bias"] = torch.zeros((d,), dtype=torch.float32)
        return p
    if cfg.norm_type == "nonparametric_ln":   # OLMo
        return {}
    raise ValueError(f"unknown norm {cfg.norm_type!r}")


def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-6):
    """The scale (and bias) multiply in fp32, as in JAX: they are leaves
    that ``lm.cast_params`` keeps in their stored dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (nrm * params["scale"]).to(x.dtype)
    if cfg.norm_type not in ("layernorm", "nonparametric_ln"):
        raise ValueError(f"unknown norm {cfg.norm_type!r}")
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)   # population, as jnp.var
    nrm = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm_type == "layernorm":
        nrm = nrm * params["scale"]
        if "bias" in params:
            nrm = nrm + params["bias"]
    return nrm.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int.  Half-split rotation."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq     # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; causal prefill on the kernel, one-token decode)
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init((d, h * hd), generator),
        "wk": dense_init((d, kv * hd), generator),
        "wv": dense_init((d, kv * hd), generator),
        "wo": dense_init((h * hd, d), generator),
    }


def _project_qkv(p, x, cfg: ModelConfig, n_heads, n_kv, dtype):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    return (q.reshape(b, s, n_heads, hd), k.reshape(b, s, n_kv, hd),
            v.reshape(b, s, n_kv, hd))


def attention_forward(p, x, cfg: ModelConfig, *, positions, mode: str,
                      window: int = 0, return_kv: bool = False):
    """Full-sequence attention: ``mode="causal"``, or ``"local"`` (causal
    within ``window`` keys: ``q - k < window``).  Other modes of the JAX
    function (bidir, cross) wait for the families that use them.

    The flash kernel takes the ``(B, S, H, D)`` projections as strided
    ``(B, H, S, D)`` views and returns a view whose transpose is the
    contiguous ``(B, S, H, D)`` output, so no layout copy is made.  Under
    autograd the backward kernel writes dq, dk, dv the same way: the
    gradient of each transposed view arrives as a contiguous
    ``(B, S, H, D)`` tensor, again without a copy.
    """
    if mode not in ("causal", "local"):
        raise ValueError(f"attention mode {mode!r} is not ported yet")
    if mode == "local" and window <= 0:
        raise ValueError("local attention needs window > 0")
    dtype = x.dtype
    h, kv = cfg.n_heads, cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, h, kv, dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=True,
                           window=window if mode == "local" else 0)
    out = out.transpose(1, 2).reshape(*x.shape[:2], h * cfg.head_dim)
    out = out @ p["wo"].to(dtype)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, x, cache, cfg: ModelConfig, *, pos, window: int = 0,
                     rows=None):
    """One-token decode over a cache ``{"k","v"}: (B, S_cache, KV, D)``.
    ``pos`` is the absolute position: a Python int shared by the batch, or
    a per-row ``(B,)`` int tensor (continuous batching).  With
    ``window > 0`` the cache is a rolling ring of ``window`` slots: the new
    entry goes to slot ``pos % window``, and a slot is valid once written
    (every slot once ``pos >= window``).

    Unlike the JAX function, the new K/V entry is written into ``cache``
    **in place**, and only for the batch rows in ``rows`` (a 1-d index
    tensor; ``None`` = every row).  Rows outside ``rows`` are never written,
    so an idle slot's cache row stays bit-identical; their attention output
    reads their old cache and is discarded by the caller.
    """
    dtype = x.dtype
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg, h, kv, dtype)
    per_row = isinstance(pos, torch.Tensor) and pos.ndim > 0
    if per_row:
        posb = pos.reshape(b, 1).to(device=x.device, dtype=torch.int64)
    else:
        posb = torch.full((b, 1), int(pos), dtype=torch.int64,
                          device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(k_new, posb, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot = posb % window if window else posb
    r = torch.arange(b, device=x.device) if rows is None else rows
    ck[r, slot[r, 0]] = k_new[r, 0].to(ck.dtype)
    cv[r, slot[r, 0]] = v_new[r, 0].to(cv.dtype)
    idx = torch.arange(ck.shape[1], device=x.device)[None]
    valid = idx <= slot                                          # (B, S)
    if window:
        valid = (valid | (posb >= window)) & (idx < window)
    g = h // kv
    qg = q.reshape(b, kv, g, hd).to(torch.float32)
    # bf16 operands, fp32 products and sums: preferred_element_type=f32
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          ck.to(dtype).to(torch.float32))
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(dtype).to(torch.float32),
                       cv.to(dtype).to(torch.float32)).to(dtype)
    out = out.reshape(b, 1, h * hd)
    return out @ p["wo"].to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"mlp {cfg.mlp_type!r} is not ported yet")
    return {
        "w_gate": dense_init((d, ff), generator),
        "w_up": dense_init((d, ff), generator),
        "w_down": dense_init((ff, d), generator),
    }


def mlp_forward(p, x):
    dtype = x.dtype
    gate = F.silu(x @ p["w_gate"].to(dtype))
    up = x @ p["w_up"].to(dtype)
    return (gate * up) @ p["w_down"].to(dtype)
