"""Model assembly of the families the port runs.

Counterpart of ``repro.models.lm`` for all its branches: the decoder-only
dense and MoE (olmo-1b, deepseek-coder-33b, granite-20b, command-r-plus-104b's
parallel block, granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b, and
llava-next-mistral-7b, whose precomputed image embeddings go before the
text), RWKV-6 (rwkv6-3b), RG-LRU hybrid (recurrentgemma-2b) and
encoder-decoder (whisper-small: a bidirectional encoder over precomputed
frame embeddings, decoder layers with cross-attention):

  init_params(cfg, generator, device, cast=)     -> params dict
  params_from_jax(np_tree, cfg, device)          -> params dict
  cast_params(params, cfg)                       -> params in compute dtype
  forward_train(params, cfg, batch)              -> (loss, metrics)
  init_cache(cfg, batch, cache_len, device=...)  -> cache dict
  prefill(params, cfg, batch, cache_len)         -> (last_logits, cache)
  decode_step(params, cfg, cache, tokens, pos)   -> (logits, cache)

The params dict has the JAX pytree's structure and leaf shapes: layer
leaves are stacked along leading axes (``layers``: ``(L, ...)``; the hybrid's
``super`` block: ``(n_super, ...)`` with its ``rec`` stack
``(n_super, rec_per_attn, ...)``; ``tail``: ``(n_tail, ...)``; the
encoder's ``enc_layers``: ``(encoder_layers, ...)``) and Python loops walk
them.  Weights are stored in ``param_dtype`` and cast to the
compute dtype at every use, as in JAX; :func:`cast_params` makes that cast
once, after which every ``.to(dtype)`` is a no-op (``init_params(...,
cast=True)`` draws the params already cast, a layer at a time).  The leaves
JAX reads in fp32 (:data:`FP32_READ`) keep their stored dtype.  Training
(:func:`forward_train`) runs every branch and casts at each use, so that
the fp32 parameters get fp32 gradients; the scans and the attention
differentiate through their backward kernels (``kernels/*/ops.py``), and
the MoE layer's load-balancing loss enters the loss as in JAX.
"""
from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (batch_grad, commit_rows, constrain,
                                    fsdp_gathered, is_dtensor, local_bounds,
                                    local_call,
                                    placements_for, redistribute, reduced,
                                    vocab_lookup, write_slice)
from ..obs import trace
from ..tree import tree_map
from . import rglru as rg
from . import rwkv6 as rw
from .config import ModelConfig
from .layers import (apply_norm, attention_decode, attention_forward,
                     dense_init, init_attention, init_mlp, init_moe,
                     init_norm, mlp_forward, moe_forward)

__all__ = ["init_params", "abstract_params", "params_from_jax", "cast_params",
           "init_cache", "prefill", "decode_step", "output_weights",
           "check_family", "check_train_family", "forward_train", "backbone",
           "chunked_xent", "hybrid_layout", "commit_axes", "CACHE_BATCH_AXIS",
           "FP32_READ", "TRAIN_FAMILIES"]

#: batch axis of every leaf of the dense cache (L, B, S, KV, D)
CACHE_BATCH_AXIS = 1

#: leaves the JAX model reads in fp32 (no ``.astype(dtype)`` at use): the
#: RWKV decay base, bonus and group-norm scale, the RG-LRU gate biases and
#: Lambda, and the norms' scale and bias
FP32_READ = frozenset({"ww", "u", "ln_scale", "ba", "bx", "lam", "scale",
                       "bias"})


#: the families the port serves and trains: every family of the JAX package
TRAIN_FAMILIES = ("olmo-1b", "deepseek-coder-33b", "granite-20b",
                  "command-r-plus-104b", "granite-moe-1b-a400m",
                  "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "recurrentgemma-2b",
                  "whisper-small", "llava-next-mistral-7b")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config outside the JAX package's
    families: an unknown block or MLP type, an RWKV-6 width off its
    64-wide heads, an RG-LRU hybrid without a window."""
    if (cfg.block_type not in ("llama", "parallel")
            or cfg.mlp_type not in ("swiglu", "gelu")):
        raise ValueError(f"{cfg.name}: not a config of the families the "
                         f"port runs ({', '.join(TRAIN_FAMILIES)})")
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
    place (the dense, encoder-decoder and RWKV leaves on axis 1; the
    hybrid's per-block ``h``/``conv`` stacks ``(n_super, rec_per_attn, B,
    ...)`` on axis 2).  Decode never writes the encoder-decoder's
    ``cross_k``/``cross_v``; prefill and snapshots move them on axis 1."""
    if cfg.rwkv:
        return {"S": 1, "x_tm": 1, "x_cm": 1}
    if cfg.rglru:
        axes = {"h": 2, "conv": 2, "k": 1, "v": 1}
        if hybrid_layout(cfg)[1]:
            axes.update(tail_h=1, tail_conv=1)
        return axes
    axes = {"k": CACHE_BATCH_AXIS, "v": CACHE_BATCH_AXIS}
    if cfg.is_encdec:
        axes.update(cross_k=CACHE_BATCH_AXIS, cross_v=CACHE_BATCH_AXIS)
    return axes


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _stored(cfg: ModelConfig, cast: bool):
    """leaf name -> the dtype the params keep it in: ``param_dtype``; with
    ``cast`` the compute dtype, but for :data:`FP32_READ`."""
    pdt, cdt = getattr(torch, cfg.param_dtype), compute_dtype(cfg)
    return lambda name: cdt if cast and name not in FP32_READ else pdt


def _store(tree, dtype_of, device):
    """``tree``'s leaves on ``device`` in their stored dtypes."""
    return {k: _store(v, dtype_of, device) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype_of(k))
            for k, v in tree.items()}


def _alloc(tree, n: int, dtype_of, device):
    """Empty ``(n, ...)`` buffers for ``n`` layers shaped like ``tree``."""
    return {k: _alloc(v, n, dtype_of, device) if isinstance(v, dict)
            else torch.empty((n, *v.shape), dtype=dtype_of(k), device=device)
            for k, v in tree.items()}


def _write(bufs, layer, i: int):
    for k, v in layer.items():
        if isinstance(v, dict):
            _write(bufs[k], v, i)
        else:
            bufs[k][i] = v          # cast and copied


def _stack(n: int, draw, dtype_of, device):
    """``n`` layers drawn one after another by ``draw()``, each written
    into ``(n, ...)`` buffers allocated once on ``device`` in the stored
    dtypes, so that only one layer is ever held in fp32."""
    bufs = None
    for i in range(n):
        layer = draw()
        if bufs is None:
            bufs = _alloc(layer, n, dtype_of, device)
        _write(bufs, layer, i)
    return bufs


def _init_dense_layer(generator, cfg: ModelConfig):
    """A parallel block (one norm feeding attention and MLP) has no
    ``ln2``; an MoE layer holds ``moe`` in place of ``mlp``."""
    d = cfg.d_model
    p = {"ln1": init_norm(cfg, d), "attn": init_attention(generator, cfg)}
    if cfg.block_type != "parallel":
        p["ln2"] = init_norm(cfg, d)
    if cfg.is_moe:
        p["moe"] = init_moe(generator, cfg)
    else:
        p["mlp"] = init_mlp(generator, cfg)
    return p


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


def _init_cross_layer(generator, cfg: ModelConfig):
    """A decoder layer of the encoder-decoder: causal self-attention,
    cross-attention (``ln_x``, ``xattn``) and the MLP."""
    d = cfg.d_model
    return {"ln1": init_norm(cfg, d), "attn": init_attention(generator, cfg),
            "ln_x": init_norm(cfg, d),
            "xattn": init_attention(generator, cfg),
            "ln2": init_norm(cfg, d), "mlp": init_mlp(generator, cfg)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                *, cast: bool = False):
    """Seeded init with the JAX package's structure, shapes and scales.

    Draws on ``generator``'s device, one layer at a time in fp32, and
    writes each into stacked buffers on ``device`` (the generator's device
    when None) in ``param_dtype``; with ``cast``, in the compute dtype but
    for :data:`FP32_READ` (the values of :func:`cast_params` on the
    ``param_dtype`` tree, which then copies nothing), so that a model whose
    fp32 tree would not fit the device is drawn straight into its serving
    form.  The numbers differ from ``jax.random``; the tests load JAX
    weights through :func:`params_from_jax` instead.
    """
    check_family(cfg)
    d = cfg.d_model
    device = device if device is not None else generator.device
    dtype_of = _stored(cfg, cast)

    def stack(n, draw):
        return _stack(n, draw, dtype_of, device)

    params = {"embed": dense_init((cfg.vocab_size, d), generator, in_axis=1),
              "final_norm": init_norm(cfg, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab_size), generator)
    params = _store(params, dtype_of, device)
    if cfg.rwkv:
        params["ln_in"] = _store(init_norm(cfg, d), dtype_of, device)
        params["layers"] = stack(cfg.n_layers,
                                 lambda: _init_rwkv_layer(generator, cfg))
    elif cfg.rglru:
        n_super, n_tail = hybrid_layout(cfg)
        params["super"] = stack(n_super, lambda: {
            "rec": stack(cfg.rec_per_attn,
                         lambda: _init_rec_layer(generator, cfg)),
            "attn": _init_dense_layer(generator, cfg)})
        if n_tail:
            params["tail"] = stack(n_tail,
                                   lambda: _init_rec_layer(generator, cfg))
    elif cfg.is_encdec:
        # learned positions, 0.02 x the dense init, as in JAX
        params.update(_store({
            "enc_pos": 0.02 * dense_init((cfg.n_frames, d), generator),
            "dec_pos": 0.02 * dense_init((cfg.max_decode_len, d), generator),
            "enc_norm": init_norm(cfg, d)}, dtype_of, device))
        params["enc_layers"] = stack(
            cfg.encoder_layers, lambda: _init_dense_layer(generator, cfg))
        params["layers"] = stack(cfg.n_layers,
                                 lambda: _init_cross_layer(generator, cfg))
    else:
        params["layers"] = stack(cfg.n_layers,
                                 lambda: _init_dense_layer(generator, cfg))
    return params


def abstract_params(cfg: ModelConfig, *, cast: bool = False):
    """:func:`init_params`'s tree on the ``meta`` device: the shapes and
    dtypes, nothing drawn or allocated (the counterpart of
    ``jax.eval_shape`` of JAX's init)."""
    meta = types.SimpleNamespace(device=torch.device("meta"))
    return init_params(cfg, meta, cast=cast)


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
    """Layer ``i`` of a stack, its weights gathered over the batch's mesh
    axes (``fsdp_gathered``; identity on plain tensors)."""
    return tree_map(lambda t: fsdp_gathered(t[i]), layers)


def _gathered(tree):
    """``fsdp_gathered`` over a layer's dicts and lists of dicts."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gathered(v) for v in tree]
    return fsdp_gathered(tree)


def output_weights(params, cfg: ModelConfig, dtype):
    """The (D, V) output projection; a DTensor's is gathered along D (FSDP)
    and keeps its vocabulary split, so the logits keep the batch's."""
    w = (params["embed"].to(dtype).T if cfg.tie_embeddings
         else params["lm_head"].to(dtype))
    if is_dtensor(w):
        w = redistribute(w, placements_for(w, {1}))
    return w


def _embed(params, tokens, dtype):
    # gather, then cast: the same values as casting the table first (a
    # DTensor table: each rank looks up the rows it holds, summed over the
    # vocabulary's mesh axes)
    table = params["embed"]
    x = (vocab_lookup(tokens, table) if is_dtensor(table)
         else F.embedding(tokens.long(), table))
    return constrain(x.to(dtype), ("batch", "seq", "embed"))


def check_train_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless the port trains ``cfg``'s family (every
    family it serves)."""
    check_family(cfg)


# ---------------------------------------------------------------------------
# training: chunked cross-entropy, the layer stack, forward_train
# ---------------------------------------------------------------------------

def _xent_sums(logits, tc, mc):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def _xent_piece(hc, w_out, tc, mc):
    # marked inside the remat unit, so that its recompute is marked too
    with trace.range("lm.xent"):
        logits = (hc @ w_out).to(torch.float32)              # (B, C, V)
        if not is_dtensor(logits):
            return _xent_sums(logits, tc, mc)
        rows = placements_for(logits, {0})
        if any(isinstance(p, Shard) and p.dim == 2
               for p in logits.placements):
            return _xent_vocab_split(logits, tc, mc, rows)
        part = batch_grad(rows)
        t, c = local_call(_xent_sums, (logits, tc, mc), (rows, rows, rows),
                          (part, part))
        return reduced(t), reduced(c)


def _xent_vocab_split(logits, tc, mc, rows):
    """:func:`_xent_sums` on logits whose vocabulary is split over mesh
    axes (Megatron's vocab-parallel cross-entropy): the row max and the
    exponentials' sum are reduced over those axes, and each rank picks the
    gold logits of the targets in its own rows of the vocabulary."""
    at = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in logits.placements]
    logits = redistribute(logits, at)
    # a constant shift: the max carries no gradient (lse does not depend
    # on it)
    top = reduced(logits.detach().amax(-1, keepdim=True))
    lse = top[..., 0] + torch.log(reduced(torch.exp(logits - top).sum(-1)))
    (_, _, v_rows), (_, _, v0) = local_bounds(logits)

    def gold_of(x, t):
        ids = t.long() - v0
        own = (ids >= 0) & (ids < v_rows)
        g = torch.gather(x, -1, ids.clamp(0, v_rows - 1)[..., None])[..., 0]
        return torch.where(own, g, torch.zeros_like(g))

    summed = [Partial() if isinstance(p, Shard) and p.dim == 2 else r
              for p, r in zip(at, rows)]
    gold = reduced(local_call(gold_of, (logits, tc), (at, rows), summed,
                              (at, rows)))
    part = batch_grad(rows)
    t = local_call(lambda d, m: (d * m).sum(), (lse - gold, mc),
                   (rows, rows), part)
    c = local_call(lambda m: m.sum(), (mc,), (rows,), part)
    return reduced(t), reduced(c)


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


def _ffn(p, h, cfg: ModelConfig):
    """The layer's MLP or MoE on ``h``: (out, aux loss; 0 for an MLP)."""
    if cfg.is_moe:
        return moe_forward(p["moe"], h, cfg)
    return mlp_forward(p["mlp"], h), 0.0


def _dense_block(p, x, cfg: ModelConfig, positions, mode="causal",
                 window=0):
    """One decoder layer: (x, its MoE aux loss).  A parallel block (Cohere)
    feeds one norm's output to attention and the MLP and adds both."""
    ffn = "layer.moe" if cfg.is_moe else "layer.mlp"
    with trace.range("layer.attn"):
        h = apply_norm(cfg, p["ln1"], x)
        a = attention_forward(p["attn"], h, cfg, positions=positions,
                              mode=mode, window=window)
    if cfg.block_type == "parallel":
        with trace.range(ffn):
            m, aux = _ffn(p, h, cfg)
        return x + a + m, aux
    x = x + a
    with trace.range(ffn):
        m, aux = _ffn(p, apply_norm(cfg, p["ln2"], x), cfg)
    return x + m, aux


def _rec_block(p, x, cfg: ModelConfig):
    h = apply_norm(cfg, p["ln1"], x)
    r, _ = rg.rglru_block_forward(p["rec"], h, cfg)
    x = x + r
    with trace.range("layer.mlp"):
        return x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))


def _super_block(p, x, cfg: ModelConfig, positions):
    """The hybrid's ``rec_per_attn`` recurrent blocks, then its local
    attention block (``p["rec"]`` a list of per-layer views)."""
    for rp in p["rec"]:
        x = _rec_block(rp, x, cfg)
    return _dense_block(p["attn"], x, cfg, positions, "local",
                        cfg.window)[0]


def _rwkv_block(p, x, cfg: ModelConfig):
    h = apply_norm(cfg, p["ln1"], x)
    zeros = torch.zeros_like(x[:, 0])
    t, _ = rw.time_mix_forward(p["tm"], h, zeros, cfg)
    x = x + t
    c, _ = rw.channel_mix_forward(p["cm"], apply_norm(cfg, p["ln2"], x),
                                  zeros)
    return x + c


def _cross_block(p, x, cfg: ModelConfig, positions, enc_out):
    """An encoder-decoder decoder layer: causal self-attention, then
    cross-attention to ``enc_out``, then the MLP, each after its norm."""
    with trace.range("layer.attn"):
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attention_forward(p["attn"], h, cfg, positions=positions,
                                  mode="causal")
    with trace.range("layer.attn"):
        h = apply_norm(cfg, p["ln_x"], x)
        x = x + attention_forward(p["xattn"], h, cfg, positions=positions,
                                  mode="cross", context=enc_out)
    with trace.range("layer.mlp"):
        return x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))


def _unstack(layers, n: int):
    """Per-layer views of the stacked leaves: ``unbind`` once, so that the
    backward stacks each leaf's layer gradients once (indexing layer by
    layer would give every layer a full-depth zero gradient to add)."""
    unbound = tree_map(lambda t: t.unbind(0), layers)
    return [tree_map(lambda u: u[i], unbound) for i in range(n)]


def _run(block, p, x, cfg: ModelConfig, *args):
    """One remat unit: under ``torch.utils.checkpoint`` (non-reentrant)
    with ``cfg.remat``, as ``jax.checkpoint`` wraps the body of JAX's
    ``_scan_layers``; its input is laid out as JAX's scan step constrains
    the carry (the sequence-parallel residual).  A DTensor layer's weights
    are gathered over the batch's mesh axes inside the unit (FSDP), so
    that the backward gathers them again rather than keeping them."""
    x = constrain(x, ("batch", "seq_resid", "embed"))

    def unit(p, x, *args):
        return block(_gathered(p), x, cfg, *args)

    if cfg.remat:
        return checkpoint(unit, p, x, *args, use_reentrant=False)
    return unit(p, x, *args)


def _encoder(params, cfg: ModelConfig, frames):
    """The encoder-decoder's encoder on the frame embeddings (B, T, D):
    plus ``enc_pos``, the bidirectional layers (each a remat unit), then
    ``enc_norm``; in the compute dtype."""
    dtype = compute_dtype(cfg)
    x = frames.to(dtype) + params["enc_pos"].to(dtype)[None]
    for p in _unstack(params["enc_layers"], cfg.encoder_layers):
        x = _run(_dense_block, p, x, cfg, None, "bidir")[0]
    return apply_norm(cfg, params["enc_norm"], x)


def backbone(params, cfg: ModelConfig, x, positions, *, enc_out=None):
    """The layer stack on the embedded input x (B, S, D), then the final
    norm, as JAX's ``backbone`` orders it: dense or MoE decoder layers; or
    ``ln_in`` and the RWKV layers (zero shift states); or the hybrid's
    super blocks of ``rec_per_attn`` recurrent blocks and a local-attention
    block, then its ``tail`` recurrent layers; or the encoder-decoder's
    decoder layers, attending to ``enc_out`` (:func:`_encoder`'s).  With
    ``cfg.remat`` each remat unit (a layer; a whole super block; a tail
    layer) is recomputed in the backward, so its kernels' forwards run
    twice a step.  Returns (h, aux): the MoE layers' load-balancing losses
    summed in layer order (0 for the other families)."""
    check_train_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        x = apply_norm(cfg, params["ln_in"], x)
        for p in _unstack(params["layers"], cfg.n_layers):
            x = _run(_rwkv_block, p, x, cfg)
    elif cfg.rglru:
        n_super, n_tail = hybrid_layout(cfg)
        for sp in _unstack(params["super"], n_super):
            sp = {"rec": _unstack(sp["rec"], cfg.rec_per_attn),
                  "attn": sp["attn"]}
            x = _run(_super_block, sp, x, cfg, positions)
        if n_tail:
            for p in _unstack(params["tail"], n_tail):
                x = _run(_rec_block, p, x, cfg)
    elif cfg.is_encdec:
        for p in _unstack(params["layers"], cfg.n_layers):
            x = _run(_cross_block, p, x, cfg, positions, enc_out)
    else:
        for p in _unstack(params["layers"], cfg.n_layers):
            x, a = _run(_dense_block, p, x, cfg, positions)
            aux = aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


def forward_train(params, cfg: ModelConfig, batch, *, q_chunk: int = 1024,
                  xent_chunk: int = 512):
    """batch: {"tokens": (B, S) int, "targets": (B, S) int, "loss_mask":
    (B, S) float, and the encoder-decoder's "frames" (B, n_frames, D) or
    the image family's "image_embeds" (B, n_image_tokens, D)} tensors on the
    params' device.  The decoder adds ``dec_pos[:S]`` to the embedded
    tokens; image embeddings go before the text, positions run over both,
    and the image rows are dropped before the loss.  Returns (xent + 0.01 *
    aux, {"xent", "aux"}) as 0-d fp32 tensors, aux the MoE layers' summed
    load-balancing loss (0 for the other families).
    ``q_chunk`` is accepted for JAX's signature: the flash kernels take the
    whole sequence."""
    del q_chunk
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    with trace.range("lm.embed"):
        x = _embed(params, tokens, dtype)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encoder(params, cfg, batch["frames"])
        # slice, then cast: the values of JAX's cast table, sliced
        x = x + params["dec_pos"][:x.shape[1]].to(dtype)[None]
    if cfg.n_image_tokens:
        img = constrain(batch["image_embeds"].to(dtype),
                        ("batch", "seq", "embed"))
        x = torch.cat([img, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    h, aux = backbone(params, cfg, x, positions, enc_out=enc_out)
    h = h[:, cfg.n_image_tokens:]
    loss = chunked_xent(h, output_weights(params, cfg, dtype),
                        batch["targets"], batch["loss_mask"],
                        chunk=xent_chunk, remat=cfg.remat)
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
      ``tail_h``/``tail_conv`` ``(n_tail, B, ...)`` when layers are left over;
    * encoder-decoder: the dense leaves and the encoder's K/V for the
      cross-attention, ``cross_k``/``cross_v`` each ``(L, B, n_frames, KV,
      D)``.

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
    cache = {"k": zeros(shape), "v": zeros(shape)}
    if cfg.is_encdec:
        cross = (cfg.n_layers, batch, cfg.n_frames, *kv)
        cache.update(cross_k=zeros(cross), cross_v=zeros(cross))
    return cache


def _new_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, x):
    """:func:`init_cache` on ``x``'s device; for a DTensor ``x``, as
    DTensors laid out by ``cache_specs`` on its mesh (each rank allocates
    its shard only)."""
    if not is_dtensor(x):
        return init_cache(cfg, batch, cache_len, dtype=dtype, device=x.device)
    from ..distributed.params import init_cache_sharded
    return init_cache_sharded(cfg, batch, cache_len, x.device_mesh, dtype)


def _commit(cache, cfg: ModelConfig, name: str, index: tuple, new, rows):
    """Write ``new`` (batch first) into ``cache[name][index]`` in place,
    along that leaf's batch axis (:func:`commit_axes`), for the batch rows
    in ``rows`` only (every row when None); on a DTensor cache each rank
    writes its own rows (``commit_rows``), so the cache keeps its
    placements."""
    if is_dtensor(cache[name]):
        commit_rows(cache[name], index, new, rows)
        return
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


def _decoder_tail(p, x, hh, a, cfg: ModelConfig):
    """A serving step's decoder layer after its attention ``a`` of the
    normed ``hh``: the MLP or MoE, in a parallel block on ``hh`` beside
    ``a``, else after the residual.  The MoE aux loss is dropped, as JAX's
    prefill and decode drop it."""
    if cfg.block_type == "parallel":
        return x + a + _ffn(p, hh, cfg)[0]
    x = x + a
    return x + _ffn(p, apply_norm(cfg, p["ln2"], x), cfg)[0]


def _decode_encdec(params, cfg: ModelConfig, cache, x, pos, rows):
    """Each row's ``dec_pos`` at its own position, then the decoder layers:
    self-attention over the cache, cross-attention over the prefilled
    ``cross_k``/``cross_v`` (never written here), the MLP."""
    at = pos.reshape(-1).long() if isinstance(pos, torch.Tensor) else pos
    x = x + params["dec_pos"][at].to(x.dtype).reshape(-1, 1, cfg.d_model)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        hh = apply_norm(cfg, p["ln1"], x)
        x = x + attention_decode(p["attn"], hh,
                                 {"k": cache["k"][i], "v": cache["v"][i]},
                                 cfg, pos=pos, rows=rows)
        hh = apply_norm(cfg, p["ln_x"], x)
        x = x + attention_decode(
            p["xattn"], hh, None, cfg, pos=pos,
            cross_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        x = x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))
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
    elif cfg.is_encdec:
        x = _decode_encdec(params, cfg, cache, x, pos, rows)
    else:
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            hh = apply_norm(cfg, p["ln1"], x)
            a = attention_decode(p["attn"], hh,
                                 {"k": cache["k"][i], "v": cache["v"][i]},
                                 cfg, pos=pos, rows=rows)
            x = _decoder_tail(p, x, hh, a, cfg)
    h = apply_norm(cfg, params["final_norm"], x)
    logits = (h[:, 0] @ output_weights(params, cfg, dtype)).to(torch.float32)
    return constrain(logits, ("batch", "vocab")), cache


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
        write_slice(cache["S"], (i,), S)
        write_slice(cache["x_tm"], (i,), x_tm.to(dtype))
        write_slice(cache["x_cm"], (i,), x_cm.to(dtype))
    return x


def _prefill_hybrid(params, cfg: ModelConfig, cache, x, positions):
    """The ring holds the last ``w`` keys: position ``p`` at slot
    ``p % w``, as the decode step will continue it."""
    dtype = x.dtype
    s = x.shape[1]
    w = cache["k"].shape[2]
    ring = (slice(None), slice(0, min(s, w)))

    def last_w(t):
        # the last w positions rotated so that position p sits at p % w
        t = t[:, -w:].to(dtype)
        return torch.roll(t, s % w, dims=1) if s >= w else t

    n_super, n_tail = hybrid_layout(cfg)
    for si in range(n_super):
        sp = _layer(params["super"], si)
        for ri in range(cfg.rec_per_attn):
            x, st = _rec_prefill(_layer(sp["rec"], ri), x, cfg)
            write_slice(cache["h"], (si, ri), st["h"])
            write_slice(cache["conv"], (si, ri), st["conv"])
        ap = sp["attn"]
        a, (k, v) = attention_forward(
            ap["attn"], apply_norm(cfg, ap["ln1"], x), cfg,
            positions=positions, mode="local", window=cfg.window,
            return_kv=True)
        x = x + a
        x = x + mlp_forward(ap["mlp"], apply_norm(cfg, ap["ln2"], x))
        write_slice(cache["k"], (si, *ring), last_w(k))
        write_slice(cache["v"], (si, *ring), last_w(v))
    for ti in range(n_tail):
        x, st = _rec_prefill(_layer(params["tail"], ti), x, cfg)
        write_slice(cache["tail_h"], (ti,), st["h"])
        write_slice(cache["tail_conv"], (ti,), st["conv"])
    return x


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            last_idx=None):
    """batch: {"tokens": (B, S)}, with the encoder-decoder's "frames" or
    the image family's "image_embeds" as in :func:`forward_train`.  Returns
    (last-token logits (B, V) fp32, cache primed for position S, in the
    compute dtype); the image embeddings take the first ``n_image_tokens``
    positions, so the cache is primed for ``n_image_tokens + S`` there, and
    the encoder-decoder's cache also holds the cross-attention K/V of the
    encoder's output (one encoder run a prefill).

    ``last_idx`` (optional (B,) int, counted from the first image position)
    selects a per-row logits position instead of the last: the engine
    right-pads dense prompts to a bucket length.  Causality keeps right
    padding out of positions ``<= last_idx``, and the decode loop
    overwrites each padded KV entry before the mask admits it.  The
    recurrent families take every position as a state update, so the engine
    prefills them at the exact prompt length.
    """
    dtype = compute_dtype(cfg)
    x = _embed(params, batch["tokens"], dtype)
    if cfg.n_image_tokens:
        img = constrain(batch["image_embeds"].to(dtype),
                        ("batch", "seq", "embed"))
        x = torch.cat([img, x], dim=1)
    b, s = x.shape[:2]
    if s > cache_len:
        raise ValueError(f"prefill length {s} exceeds cache_len {cache_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = _new_cache(cfg, b, cache_len, dtype, x)
    if cfg.rwkv:
        x = _prefill_rwkv(params, cfg, cache, x)
    elif cfg.rglru:
        x = _prefill_hybrid(params, cfg, cache, x, positions)
    else:
        enc_out = None
        if cfg.is_encdec:
            enc_out = _encoder(params, cfg, batch["frames"])
            x = x + params["dec_pos"][:s].to(dtype)[None]
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            hh = apply_norm(cfg, p["ln1"], x)
            a, (k, v) = attention_forward(p["attn"], hh, cfg,
                                          positions=positions, mode="causal",
                                          return_kv=True)
            if cfg.is_encdec:
                x = x + a
                hh = apply_norm(cfg, p["ln_x"], x)
                ax, (xk, xv) = attention_forward(
                    p["xattn"], hh, cfg, positions=positions, mode="cross",
                    context=enc_out, return_kv=True)
                x = x + ax
                x = x + mlp_forward(p["mlp"], apply_norm(cfg, p["ln2"], x))
                write_slice(cache["cross_k"], (i,), xk.to(dtype))
                write_slice(cache["cross_v"], (i,), xv.to(dtype))
            else:
                x = _decoder_tail(p, x, hh, a, cfg)
            write_slice(cache["k"], (i, slice(None), slice(0, s)),
                        k.to(dtype))
            write_slice(cache["v"], (i, slice(None), slice(0, s)),
                        v.to(dtype))
    h = apply_norm(cfg, params["final_norm"], x)
    if last_idx is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(b, device=h.device),
                   last_idx.to(device=h.device, dtype=torch.int64)]
    logits = (h_last @ output_weights(params, cfg, dtype)).to(torch.float32)
    return constrain(logits, ("batch", "vocab")), cache
