"""Model assembly for the dense decoder family (olmo-1b), serving half.

Counterpart of ``repro.models.lm`` (dense branch):

  init_params(cfg, generator, device)            -> params dict
  params_from_jax(np_tree, cfg, device)          -> params dict
  cast_params(params, cfg)                       -> params in compute dtype
  init_cache(cfg, batch, cache_len, device=...)  -> cache dict
  prefill(params, cfg, batch, cache_len)         -> (last_logits, cache)
  decode_step(params, cfg, cache, tokens, pos)   -> (logits, cache)

The params dict has the JAX pytree's structure and leaf shapes: the layer
leaves are stacked along a leading ``L`` axis and a Python loop walks the
layers.  Weights are stored in ``param_dtype`` and cast to the compute dtype
at every use, as in JAX; :func:`cast_params` makes the cast once, after
which every ``.to(dtype)`` is a no-op.  Training (``forward_train``) waits
for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .layers import (apply_norm, attention_decode, attention_forward,
                     dense_init, init_attention, init_mlp, init_norm,
                     mlp_forward)

__all__ = ["init_params", "params_from_jax", "cast_params", "init_cache",
           "prefill", "decode_step", "output_weights", "check_family",
           "CACHE_BATCH_AXIS"]

#: batch axis of every leaf of the dense cache (L, B, S, KV, D)
CACHE_BATCH_AXIS = 1


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the port does not run yet."""
    if (cfg.family != "dense" or cfg.rwkv or cfg.rglru or cfg.is_encdec
            or cfg.is_moe or cfg.n_image_tokens or cfg.use_bias
            or cfg.block_type != "llama"):
        raise ValueError(f"{cfg.name}: only the dense llama-block family is "
                         f"ported so far")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Seeded init with the JAX package's structure, shapes and scales.

    Draws on ``generator``'s device and moves the result to ``device`` (the
    generator's device when None).  The numbers differ from ``jax.random``;
    the tests load JAX weights through :func:`params_from_jax` instead.
    """
    check_family(cfg)
    d = cfg.d_model
    params = {"embed": dense_init((cfg.vocab_size, d), generator, in_axis=1),
              "final_norm": init_norm(cfg, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab_size), generator)
    params["layers"] = _stack([
        {"ln1": init_norm(cfg, d), "attn": init_attention(generator, cfg),
         "ln2": init_norm(cfg, d), "mlp": init_mlp(generator, cfg)}
        for _ in range(cfg.n_layers)])
    pdt = getattr(torch, cfg.param_dtype)
    device = device if device is not None else generator.device
    return _tree_map(lambda t: t.to(device=device, dtype=pdt), params)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Map a JAX params pytree, converted to numpy (stacked ``layers``
    leaves of shape ``(L, ...)``), onto the port's params.  bf16 leaves go
    through float32, since torch cannot read numpy's bf16."""
    check_family(cfg)

    def conv(a):
        a = np.asarray(a)
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)   # a writable copy

    return _tree_map(conv, np_tree)


def cast_params(params, cfg: ModelConfig):
    """The params in the compute dtype: the once-only form of the JAX
    package's per-use ``.astype(dtype)`` (identical values)."""
    dtype = compute_dtype(cfg)
    return _tree_map(lambda t: t.to(dtype), params)


def _layer(layers, i: int):
    return _tree_map(lambda t: t[i], layers)


def output_weights(params, cfg: ModelConfig, dtype):
    if cfg.tie_embeddings:
        return params["embed"].to(dtype).T
    return params["lm_head"].to(dtype)


def _embed(params, tokens, dtype):
    # gather, then cast: the same values as casting the table first
    return params["embed"][tokens.long()].to(dtype)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zero cache covering positions [0, cache_len): ``{"k", "v"}`` each
    ``(L, B, cache_len, KV, D)``.  ``device="meta"`` allocates nothing."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *, live=None):
    """tokens: (B, 1) int; pos: absolute position, a Python int or a per-row
    (B,) int tensor.  Returns (logits (B, V) fp32, cache).

    The cache is updated **in place** (the JAX function returns a new one).
    With ``live`` (a (B,) bool tensor) only the live rows are written: the
    idle rows of the cache stay bit-identical.
    """
    dtype = compute_dtype(cfg)
    x = _embed(params, tokens, dtype)
    rows = None if live is None else torch.nonzero(live.to(x.device))[:, 0]
    layers = params["layers"]
    for i in range(cfg.n_layers):
        p = _layer(layers, i)
        hh = apply_norm(cfg, p["ln1"], x)
        a = attention_decode(p["attn"], hh,
                             {"k": cache["k"][i], "v": cache["v"][i]}, cfg,
                             pos=pos, rows=rows)
        x = x + a
        x = x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))
    h = apply_norm(cfg, params["final_norm"], x)
    logits = (h[:, 0] @ output_weights(params, cfg, dtype)).to(torch.float32)
    return logits, cache


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            last_idx=None):
    """batch: {"tokens": (B, S)}.  Returns (last-token logits (B, V) fp32,
    cache primed for position S, in the compute dtype).

    ``last_idx`` (optional (B,) int) selects a per-row logits position
    instead of ``S - 1``: the engine right-pads prompts to a bucket length.
    Causality keeps right padding out of positions ``<= last_idx``, and the
    decode loop overwrites each padded KV entry before the mask admits it.
    """
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    x = _embed(params, tokens, dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, dtype=dtype, device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        p = _layer(layers, i)
        hh = apply_norm(cfg, p["ln1"], x)
        a, (k, v) = attention_forward(p["attn"], hh, cfg,
                                      positions=positions, mode="causal",
                                      return_kv=True)
        x = x + a
        x = x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))
        cache["k"][i, :, :s] = k.to(dtype)
        cache["v"][i, :, :s] = v.to(dtype)
    h = apply_norm(cfg, params["final_norm"], x)
    if last_idx is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(b, device=h.device),
                   last_idx.to(device=h.device, dtype=torch.int64)]
    logits = (h_last @ output_weights(params, cfg, dtype)).to(torch.float32)
    return logits, cache
