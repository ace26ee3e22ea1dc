"""Model assembly of the families the port runs.

Counterpart of ``repro.models.lm`` for the dense (olmo-1b), RWKV-6
(rwkv6-3b) and RG-LRU hybrid (recurrentgemma-2b) branches:

  init_params(cfg, generator, device)            -> params dict
  params_from_jax(np_tree, cfg, device)          -> params dict
  cast_params(params, cfg)                       -> params in compute dtype
  forward_train(params, cfg, batch)              -> (loss, metrics)
  init_cache(cfg, batch, cache_len, device=...)  -> cache dict
  prefill(params, cfg, batch, cache_len)         -> (last_logits, cache)
  decode_step(params, cfg, cache, tokens, pos)   -> (logits, cache)

The params dict has the JAX pytree's structure and leaf shapes: layer
leaves are stacked along leading axes (``layers``: ``(L, ...)``; the hybrid's
``super`` block: ``(n_super, ...)`` with its ``rec`` stack
``(n_super, rec_per_attn, ...)``; ``tail``: ``(n_tail, ...)``) and Python
loops walk them.  Weights are stored in ``param_dtype`` and cast to the
compute dtype at every use, as in JAX; :func:`cast_params` makes that cast
once, after which every ``.to(dtype)`` is a no-op.  The leaves JAX reads in
fp32 (:data:`FP32_READ`) keep their stored dtype.  Training
(:func:`forward_train`) runs the dense branch only and casts at each use, so
that the fp32 parameters get fp32 gradients; the recurrent families train
once their scans have backward kernels.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map
from . import rglru as rg
from . import rwkv6 as rw
from .config import ModelConfig
from .layers import (apply_norm, attention_decode, attention_forward,
                     dense_init, init_attention, init_mlp, init_norm,
                     mlp_forward)

__all__ = ["init_params", "params_from_jax", "cast_params", "init_cache",
           "prefill", "decode_step", "output_weights", "check_family",
           "check_train_family", "forward_train", "backbone", "chunked_xent",
           "hybrid_layout", "commit_axes", "CACHE_BATCH_AXIS", "FP32_READ",
           "TRAIN_FAMILIES"]

#: batch axis of every leaf of the dense cache (L, B, S, KV, D)
CACHE_BATCH_AXIS = 1

#: leaves the JAX model reads in fp32 (no ``.astype(dtype)`` at use): the
#: RWKV decay base, bonus and group-norm scale, the RG-LRU gate biases and
#: Lambda, and the norms' scale and bias
FP32_READ = frozenset({"ww", "u", "ln_scale", "ba", "bx", "lam", "scale",
                       "bias"})


#: the families the port trains (the others serve only)
TRAIN_FAMILIES = ("olmo-1b",)


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the port does not run yet."""
    if (cfg.is_encdec or cfg.is_moe or cfg.n_image_tokens or cfg.use_bias
            or cfg.block_type != "llama" or cfg.mlp_type != "swiglu"
            or not (cfg.rwkv or cfg.rglru or cfg.family == "dense")):
        raise ValueError(f"{cfg.name}: the port serves the dense llama-block "
                         f"(olmo-1b), RWKV-6 (rwkv6-3b) and RG-LRU hybrid "
                         f"(recurrentgemma-2b) families and trains the dense "
                         f"one ({', '.join(TRAIN_FAMILIES)}) so far")
    if cfg.rwkv:
        rw.n_heads(cfg)          # raises unless d_model % 64 == 0
    if cfg.rglru and cfg.window <= 0:
        raise ValueError(f"{cfg.name}: the RG-LRU hybrid needs a local-"
                         f"attention window > 0")


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(#super blocks of [rec]*k+[attn], #tail rec layers)."""
    span = cfg.rec_per_attn + 1
    return cfg.n_layers // span, cfg.n_layers % span


def commit_axes(cfg: ModelConfig) -> dict[str, int]:
    """Batch axis of each cache leaf, as :func:`decode_step` writes it in
    place (the dense and RWKV leaves on axis 1; the hybrid's per-block
    ``h``/``conv`` stacks ``(n_super, rec_per_attn, B, ...)`` on axis 2)."""
    if cfg.rwkv:
        return {"S": 1, "x_tm": 1, "x_cm": 1}
    if cfg.rglru:
        axes = {"h": 2, "conv": 2, "k": 1, "v": 1}
        if hybrid_layout(cfg)[1]:
            axes.update(tail_h=1, tail_conv=1)
        return axes
    return {"k": CACHE_BATCH_AXIS, "v": CACHE_BATCH_AXIS}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _init_dense_layer(generator, cfg: ModelConfig):
    d = cfg.d_model
    return {"ln1": init_norm(cfg, d), "attn": init_attention(generator, cfg),
            "ln2": init_norm(cfg, d), "mlp": init_mlp(generator, cfg)}


def _init_rec_layer(generator, cfg: ModelConfig):
    d = cfg.d_model
    return {"ln1": init_norm(cfg, d),
            "rec": rg.init_rglru_block(generator, cfg),
            "ln2": init_norm(cfg, d), "mlp": init_mlp(generator, cfg)}


def _init_rwkv_layer(generator, cfg: ModelConfig):
    d = cfg.d_model
    return {"ln1": init_norm(cfg, d),
            "tm": rw.init_time_mix(generator, cfg),
            "ln2": init_norm(cfg, d),
            "cm": rw.init_channel_mix(generator, cfg)}


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
    if cfg.rwkv:
        params["ln_in"] = init_norm(cfg, d)
        params["layers"] = _stack([_init_rwkv_layer(generator, cfg)
                                   for _ in range(cfg.n_layers)])
    elif cfg.rglru:
        n_super, n_tail = hybrid_layout(cfg)
        params["super"] = _stack([
            {"rec": _stack([_init_rec_layer(generator, cfg)
                            for _ in range(cfg.rec_per_attn)]),
             "attn": _init_dense_layer(generator, cfg)}
            for _ in range(n_super)])
        if n_tail:
            params["tail"] = _stack([_init_rec_layer(generator, cfg)
                                     for _ in range(n_tail)])
    else:
        params["layers"] = _stack([_init_dense_layer(generator, cfg)
                                   for _ in range(cfg.n_layers)])
    pdt = getattr(torch, cfg.param_dtype)
    device = device if device is not None else generator.device
    return tree_map(lambda t: t.to(device=device, dtype=pdt), params)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """Map a JAX params pytree, converted to numpy (stacked layer leaves),
    onto the port's params.  bf16 leaves go through float32, since torch
    cannot read numpy's bf16."""
    check_family(cfg)

    def conv(a):
        a = np.asarray(a)
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)   # a writable copy

    return tree_map(conv, np_tree)


def cast_params(params, cfg: ModelConfig):
    """The params in the compute dtype: the once-only form of the JAX
    package's per-use ``.astype(dtype)`` (identical values).  The leaves of
    :data:`FP32_READ`, which JAX reads without that cast, keep their stored
    dtype."""
    dtype = compute_dtype(cfg)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else v if k in FP32_READ else v.to(dtype)
                for k, v in tree.items()}

    return walk(params)


def _layer(layers, i: int):
    return tree_map(lambda t: t[i], layers)


def output_weights(params, cfg: ModelConfig, dtype):
    if cfg.tie_embeddings:
        return params["embed"].to(dtype).T
    return params["lm_head"].to(dtype)


def _embed(params, tokens, dtype):
    # gather, then cast: the same values as casting the table first
    return params["embed"][tokens.long()].to(dtype)


def check_train_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless the port trains ``cfg``'s family."""
    check_family(cfg)
    if cfg.rwkv or cfg.rglru:
        raise ValueError(f"{cfg.name}: the port trains only the dense family "
                         f"({', '.join(TRAIN_FAMILIES)}) so far; the RWKV-6 "
                         f"and RG-LRU scans have no backward kernel yet")


# ---------------------------------------------------------------------------
# training: chunked cross-entropy, the layer stack, forward_train
# ---------------------------------------------------------------------------

def _xent_piece(hc, w_out, tc, mc):
    logits = (hc @ w_out).to(torch.float32)                  # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def chunked_xent(h, w_out, targets, mask, *, chunk: int = 512,
                 remat: bool = True):
    """Cross-entropy without materialising the full (B, S, V) logits: the
    sequence in chunks of ``chunk`` positions (and a remainder), summed in
    that order as JAX's scan sums them.  ``remat`` recomputes each chunk's
    logits in the backward (``torch.utils.checkpoint``), as JAX's
    ``jax.checkpoint`` does, instead of keeping (B, chunk, V) fp32 logits
    per chunk."""
    s = h.shape[1]
    chunk = min(chunk, s)
    n = s // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if s - n * chunk:
        bounds.append((n * chunk, s))
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, e in bounds:
        args = (h[:, a:e], w_out, targets[:, a:e], mask[:, a:e])
        t, c = (checkpoint(_xent_piece, *args, use_reentrant=False)
                if remat else _xent_piece(*args))
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def _dense_block(p, x, cfg: ModelConfig, positions):
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attention_forward(p["attn"], h, cfg, positions=positions,
                              mode="causal")
    return x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))


def _unstack(layers, n: int):
    """Per-layer views of the stacked leaves: ``unbind`` once, so that the
    backward stacks each leaf's layer gradients once (indexing layer by
    layer would give every layer a full-depth zero gradient to add)."""
    unbound = tree_map(lambda t: t.unbind(0), layers)
    return [tree_map(lambda u: u[i], unbound) for i in range(n)]


def backbone(params, cfg: ModelConfig, x, positions):
    """The layer stack on the embedded input x (B, S, D), then the final
    norm.  With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, as ``jax.checkpoint`` does in JAX's scan,
    so the flash-attention forward runs twice a layer per step."""
    check_train_family(cfg)
    for p in _unstack(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_dense_block, p, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _dense_block(p, x, cfg, positions)
    return apply_norm(cfg, params["final_norm"], x)


def forward_train(params, cfg: ModelConfig, batch, *, q_chunk: int = 1024,
                  xent_chunk: int = 512):
    """batch: {"tokens": (B, S) int, "targets": (B, S) int, "loss_mask":
    (B, S) float} tensors on the params' device.  Returns (loss, {"xent",
    "aux"}) as 0-d fp32 tensors; the dense branch has no auxiliary loss.
    ``q_chunk`` is accepted for JAX's signature: the flash kernels take the
    whole sequence."""
    del q_chunk
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens, dtype)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    h = backbone(params, cfg, x, positions)
    loss = chunked_xent(h, output_weights(params, cfg, dtype),
                        batch["targets"], batch["loss_mask"],
                        chunk=xent_chunk, remat=cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zero cache covering positions [0, cache_len), with the JAX layouts:

    * dense: ``{"k", "v"}`` each ``(L, B, cache_len, KV, D)``;
    * RWKV: ``S`` fp32 ``(L, B, H, 64, 64)``, ``x_tm``/``x_cm`` ``(L, B, D)``;
    * hybrid: ``h`` fp32 ``(n_super, rec_per_attn, B, W)``, ``conv``
      ``(n_super, rec_per_attn, B, conv_width - 1, W)``, ``k``/``v``
      ``(n_super, B, min(window, cache_len), KV, D)`` (a rolling ring), and
      ``tail_h``/``tail_conv`` ``(n_tail, B, ...)`` when layers are left over.

    ``device="meta"`` allocates nothing."""
    check_family(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    f32 = torch.float32
    if cfg.rwkv:
        L, h = cfg.n_layers, rw.n_heads(cfg)
        return {"S": zeros((L, batch, h, rw.HEAD_N, rw.HEAD_N), f32),
                "x_tm": zeros((L, batch, cfg.d_model)),
                "x_cm": zeros((L, batch, cfg.d_model))}
    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.rglru:
        n_super, n_tail = hybrid_layout(cfg)
        k, w = cfg.rec_per_attn, cfg.lru_width
        ring = min(cfg.window, cache_len)
        conv = (cfg.conv_width - 1, w)
        cache = {"h": zeros((n_super, k, batch, w), f32),
                 "conv": zeros((n_super, k, batch, *conv)),
                 "k": zeros((n_super, batch, ring, *kv)),
                 "v": zeros((n_super, batch, ring, *kv))}
        if n_tail:
            cache["tail_h"] = zeros((n_tail, batch, w), f32)
            cache["tail_conv"] = zeros((n_tail, batch, *conv))
        return cache
    shape = (cfg.n_layers, batch, cache_len, *kv)
    return {"k": zeros(shape), "v": zeros(shape)}


def _commit(cache, cfg: ModelConfig, name: str, index: tuple, new, rows):
    """Write ``new`` (batch first) into ``cache[name][index]`` in place,
    along that leaf's batch axis (:func:`commit_axes`), for the batch rows
    in ``rows`` only (every row when None)."""
    dst = cache[name][index]
    axis = commit_axes(cfg)[name] - len(index)
    new = new.to(dst.dtype)
    if rows is None:
        dst.copy_(new.movedim(0, axis))
    else:
        dst.index_copy_(axis, rows, new.index_select(0, rows).movedim(0, axis))


def _rec_decode(rp, x, cfg: ModelConfig, state):
    hh = apply_norm(cfg, rp["ln1"], x)
    r, st = rg.rglru_block_decode(rp["rec"], hh, state, cfg)
    x = x + r
    return x + mlp_forward(rp["mlp"], apply_norm(cfg, rp["ln2"], x)), st


def _decode_rwkv(params, cfg: ModelConfig, cache, x, rows):
    x = apply_norm(cfg, params["ln_in"], x)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        hh = apply_norm(cfg, p["ln1"], x)
        t, (S, x_tm) = rw.time_mix_decode(
            p["tm"], hh, (cache["S"][i], cache["x_tm"][i]), cfg)
        x = x + t
        hh = apply_norm(cfg, p["ln2"], x)
        c, x_cm = rw.channel_mix_decode(p["cm"], hh, cache["x_cm"][i])
        x = x + c
        for name, new in (("S", S), ("x_tm", x_tm), ("x_cm", x_cm)):
            _commit(cache, cfg, name, (i,), new, rows)
    return x


def _decode_hybrid(params, cfg: ModelConfig, cache, x, pos, rows):
    n_super, _ = hybrid_layout(cfg)
    for si in range(n_super):
        sp = _layer(params["super"], si)
        for ri in range(cfg.rec_per_attn):
            x, st = _rec_decode(_layer(sp["rec"], ri), x, cfg,
                                {"h": cache["h"][si, ri],
                                 "conv": cache["conv"][si, ri]})
            _commit(cache, cfg, "h", (si, ri), st["h"], rows)
            _commit(cache, cfg, "conv", (si, ri), st["conv"], rows)
        ap = sp["attn"]
        a = attention_decode(ap["attn"], apply_norm(cfg, ap["ln1"], x),
                             {"k": cache["k"][si], "v": cache["v"][si]}, cfg,
                             pos=pos, window=cfg.window, rows=rows)
        x = x + a
        x = x + mlp_forward(ap["mlp"], apply_norm(cfg, ap["ln2"], x))
    for ti in range(hybrid_layout(cfg)[1]):
        x, st = _rec_decode(_layer(params["tail"], ti), x, cfg,
                            {"h": cache["tail_h"][ti],
                             "conv": cache["tail_conv"][ti]})
        _commit(cache, cfg, "tail_h", (ti,), st["h"], rows)
        _commit(cache, cfg, "tail_conv", (ti,), st["conv"], rows)
    return x


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
    if cfg.rwkv:
        x = _decode_rwkv(params, cfg, cache, x, rows)
    elif cfg.rglru:
        x = _decode_hybrid(params, cfg, cache, x, pos, rows)
    else:
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            hh = apply_norm(cfg, p["ln1"], x)
            a = attention_decode(p["attn"], hh,
                                 {"k": cache["k"][i], "v": cache["v"][i]},
                                 cfg, pos=pos, rows=rows)
            x = x + a
            x = x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))
    h = apply_norm(cfg, params["final_norm"], x)
    logits = (h[:, 0] @ output_weights(params, cfg, dtype)).to(torch.float32)
    return logits, cache


def _rec_prefill(rp, x, cfg: ModelConfig):
    hh = apply_norm(cfg, rp["ln1"], x)
    r, st = rg.rglru_block_forward(rp["rec"], hh, cfg, return_state=True)
    x = x + r
    return x + mlp_forward(rp["mlp"], apply_norm(cfg, rp["ln2"], x)), st


def _prefill_rwkv(params, cfg: ModelConfig, cache, x):
    dtype = x.dtype
    x = apply_norm(cfg, params["ln_in"], x)
    zeros = torch.zeros_like(x[:, 0])
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        hh = apply_norm(cfg, p["ln1"], x)
        t, (S, x_tm) = rw.time_mix_forward(p["tm"], hh, zeros, cfg)
        x = x + t
        hh = apply_norm(cfg, p["ln2"], x)
        c, x_cm = rw.channel_mix_forward(p["cm"], hh, zeros)
        x = x + c
        cache["S"][i] = S
        cache["x_tm"][i] = x_tm.to(dtype)
        cache["x_cm"][i] = x_cm.to(dtype)
    return x


def _prefill_hybrid(params, cfg: ModelConfig, cache, x, positions):
    """The ring holds the last ``w`` keys: position ``p`` at slot
    ``p % w``, as the decode step will continue it."""
    dtype = x.dtype
    s = x.shape[1]
    w = cache["k"].shape[2]
    slots = (torch.arange(s - w, s, device=x.device) % w if s >= w
             else torch.arange(s, device=x.device))
    n_super, n_tail = hybrid_layout(cfg)
    for si in range(n_super):
        sp = _layer(params["super"], si)
        for ri in range(cfg.rec_per_attn):
            x, st = _rec_prefill(_layer(sp["rec"], ri), x, cfg)
            cache["h"][si, ri] = st["h"]
            cache["conv"][si, ri] = st["conv"]
        ap = sp["attn"]
        a, (k, v) = attention_forward(
            ap["attn"], apply_norm(cfg, ap["ln1"], x), cfg,
            positions=positions, mode="local", window=cfg.window,
            return_kv=True)
        x = x + a
        x = x + mlp_forward(ap["mlp"], apply_norm(cfg, ap["ln2"], x))
        cache["k"][si][:, slots] = k[:, -w:].to(dtype)
        cache["v"][si][:, slots] = v[:, -w:].to(dtype)
    for ti in range(n_tail):
        x, st = _rec_prefill(_layer(params["tail"], ti), x, cfg)
        cache["tail_h"][ti] = st["h"]
        cache["tail_conv"][ti] = st["conv"]
    return x


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            last_idx=None):
    """batch: {"tokens": (B, S)}.  Returns (last-token logits (B, V) fp32,
    cache primed for position S, in the compute dtype).

    ``last_idx`` (optional (B,) int) selects a per-row logits position
    instead of ``S - 1``: the engine right-pads dense prompts to a bucket
    length.  Causality keeps right padding out of positions ``<= last_idx``,
    and the decode loop overwrites each padded KV entry before the mask
    admits it.  The recurrent families take every position as a state
    update, so the engine prefills them at the exact prompt length.
    """
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    x = _embed(params, tokens, dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, dtype=dtype, device=x.device)
    if cfg.rwkv:
        x = _prefill_rwkv(params, cfg, cache, x)
    elif cfg.rglru:
        x = _prefill_hybrid(params, cfg, cache, x, positions)
    else:
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
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
