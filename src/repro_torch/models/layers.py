"""Model primitives: norms, rotary, GQA attention, MLPs, MoE.

Counterpart of ``repro.models.layers`` for every family of the JAX
package.  Parameters are plain dicts of
tensors; compute runs in the input's dtype with fp32 softmax and
normalisation.  Layouts at the public functions are the JAX package's:
activations ``(B, S, D)``, q/k/v ``(B, S, H, D)``, caches
``(B, S_cache, KV, D)``.  Causal, local (sliding-window), bidirectional
and cross (encoder-decoder) attention run on the flash attention kernel,
and under autograd (training) its gradient on the flash-attention backward
kernel; one-token decode attention is plain torch ops (the JAX package has
no kernel there either).
Every op is differentiable: weights are cast to the compute dtype at each
use (``.to(dtype)``), so training keeps fp32 parameters.  The MoE layer
routes each kept (token, choice) pair to its (expert, slot) row by gathers,
forward and backward (``kernels/moe_rows``: hand-written kernels on the
card, the plain version on the CPU), where the JAX function multiplies
one-hot dispatch and combine tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import (as_replicated, constrain, guard_spec,
                                    is_dtensor, local_call, logical_to_spec,
                                    merge_last, placements_for, put_rows,
                                    redistribute, replicated,
                                    spec_to_placements, split_dim,
                                    split_last)
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.moe_rows import ops as moe_rows
from ..obs import trace
from .config import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, in_axis: int = 0):
    """Truncated normal on [-2, 2] scaled by ``1/sqrt(fan_in)``, fp32, on
    the generator's device (on the ``meta`` device: shape only, nothing
    drawn)."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if w.device.type == "meta":
        return w
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
# attention (GQA; causal, local, bidir, cross on the kernel; decode)
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init((d, h * hd), generator),
        "wk": dense_init((d, kv * hd), generator),
        "wv": dense_init((d, kv * hd), generator),
        "wo": dense_init((h * hd, d), generator),
    }
    if cfg.use_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h * hd,), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=torch.float32, device=dev)
        p["bo"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return p


def _project_qkv(p, x, cfg: ModelConfig, n_heads, n_kv, dtype):
    """q, k, v with their biases (``use_bias``) added before rope."""
    hd = cfg.head_dim
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(dtype), k + p["bk"].to(dtype),
                   v + p["bv"].to(dtype))
    return (split_last(q, n_heads, hd), split_last(k, n_kv, hd),
            split_last(v, n_kv, hd))


def _project_cross(p, x, context, cfg: ModelConfig, dtype):
    """Cross-attention's q from ``x`` and k, v from ``context``, without
    the q/k/v biases (JAX adds none there, though the layer holds them)."""
    hd = cfg.head_dim
    q = split_last(x @ p["wq"].to(dtype), cfg.n_heads, hd)
    k = split_last(context @ p["wk"].to(dtype), cfg.n_kv_heads, hd)
    v = split_last(context @ p["wv"].to(dtype), cfg.n_kv_heads, hd)
    return q, k, v


def _out_proj(p, out, dtype):
    out = out @ p["wo"].to(dtype)
    if "bo" in p:
        out = out + p["bo"].to(dtype)
    return out


def _flash(q, k, v, *, causal: bool, window: int):
    """The flash-attention kernel on (B, H, S, D) views; on DTensors it runs
    on each rank's batch rows, every head local (q, k and v are first
    replicated on every other mesh axis, the layout JAX's constraint on q
    gives)."""
    def run(q, k, v):
        return fa_ops.attention(q, k, v, causal=causal, window=window)

    if not is_dtensor(q):
        return run(q, k, v)
    pl = placements_for(q, {0})
    return local_call(run, (q, k, v), (pl, pl, pl), pl)


def attention_forward(p, x, cfg: ModelConfig, *, positions, mode: str,
                      window: int = 0, context=None,
                      return_kv: bool = False):
    """Full-sequence attention: ``mode="causal"``; ``"local"`` (causal
    within ``window`` keys: ``q - k < window``); ``"bidir"`` (no mask, no
    rope: the encoder); or ``"cross"``: queries from ``x``, keys and values
    from ``context`` (the encoder's output, ``(B, Sk, D)``), no mask, no
    rope, no q/k/v bias, ``bo`` added after ``wo``.

    The flash kernel takes the ``(B, S, H, D)`` projections as strided
    ``(B, H, S, D)`` views and returns a view whose transpose is the
    contiguous ``(B, S, H, D)`` output, so no layout copy is made.  Under
    autograd the backward kernel writes dq, dk, dv the same way: the
    gradient of each transposed view arrives as a contiguous
    ``(B, S, H, D)`` tensor, again without a copy.
    """
    if mode not in ("causal", "local", "bidir", "cross"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode == "local" and window <= 0:
        raise ValueError("local attention needs window > 0")
    dtype = x.dtype
    if mode == "cross":
        q, k, v = _project_cross(p, x, context, cfg, dtype)
    else:
        q, k, v = _project_qkv(p, x, cfg, cfg.n_heads, cfg.n_kv_heads, dtype)
        if mode != "bidir":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "seq", None, None))
    out = _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=mode in ("causal", "local"),
                 window=window if mode == "local" else 0)
    out = merge_last(out.transpose(1, 2), 2)
    out = constrain(_out_proj(p, out, dtype), ("batch", "seq", "embed"))
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, x, cache, cfg: ModelConfig, *, pos, window: int = 0,
                     rows=None, cross_kv=None):
    """One-token decode over a cache ``{"k","v"}: (B, S_cache, KV, D)``.
    ``pos`` is the absolute position: a Python int shared by the batch, or
    a per-row ``(B,)`` int tensor (continuous batching).  With
    ``window > 0`` the cache is a rolling ring of ``window`` slots: the new
    entry goes to slot ``pos % window``, and a slot is valid once written
    (every slot once ``pos >= window``).  ``cross_kv`` (the encoder's K and
    V, each ``(B, n_frames, KV, D)``) makes it cross-attention: q without
    its bias against every frame, no cache and no mask (``cache`` unused).

    Unlike the JAX function, the new K/V entry is written into ``cache``
    **in place**, and only for the batch rows in ``rows`` (a 1-d index
    tensor; ``None`` = every row).  Rows outside ``rows`` are never written,
    so an idle slot's cache row stays bit-identical; their attention output
    reads their old cache and is discarded by the caller.
    """
    dtype = x.dtype
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    if cross_kv is not None:
        q = split_last(x @ p["wq"].to(dtype), h, hd)
        ck, cv = cross_kv
        valid = None
    else:
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
        if is_dtensor(ck):
            put_rows(ck, rows, slot[:, 0], k_new[:, 0])
            put_rows(cv, rows, slot[:, 0], v_new[:, 0])
        else:
            r = torch.arange(b, device=x.device) if rows is None else rows
            ck[r, slot[r, 0]] = k_new[r, 0].to(ck.dtype)
            cv[r, slot[r, 0]] = v_new[r, 0].to(cv.dtype)
        idx = torch.arange(ck.shape[1], device=x.device)[None]
        valid = idx <= slot                                      # (B, S)
        if window:
            valid = (valid | (posb >= window)) & (idx < window)
    g = h // kv
    qg = split_dim(q[:, 0], 1, kv, g).to(torch.float32)
    # bf16 operands, fp32 products and sums: preferred_element_type=f32
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          ck.to(dtype).to(torch.float32))
    scores = scores / math.sqrt(hd)
    # flash-decoding split: the cache *sequence* lives on the model axis
    scores = constrain(scores, ("batch", "kv_heads", None, "kv_seq"))
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(dtype).to(torch.float32),
                       cv.to(dtype).to(torch.float32)).to(dtype)
    out = merge_last(out, 3)[:, None]
    return _out_proj(p, out, dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and MoE
# ---------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``), or whisper's GELU MLP
    (``w_up``, ``w_down`` and, with ``use_bias``, ``b_up``, ``b_down``)."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "gelu":
        p = {"w_up": dense_init((d, ff), generator),
             "w_down": dense_init((ff, d), generator)}
        if cfg.use_bias:
            dev = generator.device
            p["b_up"] = torch.zeros((ff,), dtype=torch.float32, device=dev)
            p["b_down"] = torch.zeros((d,), dtype=torch.float32, device=dev)
        return p
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"unknown mlp {cfg.mlp_type!r}")
    return {
        "w_gate": dense_init((d, ff), generator),
        "w_up": dense_init((d, ff), generator),
        "w_down": dense_init((ff, d), generator),
    }


def mlp_forward(p, x):
    dtype = x.dtype
    if "w_gate" not in p:                       # GELU MLP (whisper)
        h = x @ p["w_up"].to(dtype)
        if "b_up" in p:
            h = h + p["b_up"].to(dtype)
        # jax.nn.gelu's default is the tanh approximation
        h = constrain(F.gelu(h, approximate="tanh"), ("batch", "seq", "mlp"))
        out = h @ p["w_down"].to(dtype)
        if "b_down" in p:
            out = out + p["b_down"].to(dtype)
        return constrain(out, ("batch", "seq", "embed"))
    gate = F.silu(x @ p["w_gate"].to(dtype))
    up = x @ p["w_up"].to(dtype)
    h = constrain(gate * up, ("batch", "seq", "mlp"))
    return constrain(h @ p["w_down"].to(dtype), ("batch", "seq", "embed"))


def init_moe(generator, cfg: ModelConfig):
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init((d, e), generator),
        "w_gate": dense_init((e, d, ff), generator, in_axis=1),
        "w_up": dense_init((e, d, ff), generator, in_axis=1),
        "w_down": dense_init((e, ff, d), generator, in_axis=1),
    }


MOE_GROUP = 2048  # tokens per dispatch group (GShard-style local capacity)

#: when a list, :func:`moe_forward` appends each call's routing to it as a
#: dict: ``experts`` ``(G_count, G, k)`` (each token's top k, largest
#: first), ``keep`` ``(G_count, G, k)`` bool (False: the (token, choice)
#: pair was dropped for capacity) and ``probs`` ``(G_count, G, E)`` fp32
#: (the router's softmax); instrumentation for parity checks, off by
#: default
route_log: list | None = None


def top_k_indices(x, k: int):
    """Indices of the ``k`` largest entries of the last axis, largest
    first; equal values in index order, as ``jax.lax.top_k`` gives them
    (``torch.topk`` promises no order among equals)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def moe_forward(p, x, cfg: ModelConfig):
    """GShard-style grouped top-k dispatch with capacity; returns (out,
    aux_loss), the JAX function's values.

    Tokens are dispatched within groups (:data:`MOE_GROUP` tokens when the
    sequence length is a multiple of it; a decode step's whole batch, idle
    rows included; else each sequence).  Each token takes the top ``k``
    router probabilities (ties to the lower expert index, as
    ``jax.lax.top_k``), renormalised; a (token, choice) pair takes the next
    slot of its expert in token-major order and is dropped past the
    capacity ``max(ceil(G k / E * capacity_factor), 4)``.  The kept pairs'
    tokens are gathered into ``(E, G_count * C, D)`` expert rows for three
    batched products; each token sums its kept experts' outputs in fp32,
    each weighted as JAX's combine weights it: by the sum of the token's
    renormalised gates.  The Switch load-balancing loss counts every choice,
    kept or not.
    """
    if is_dtensor(x):
        return _moe_sharded(p, x, cfg)
    return _moe(p, x, cfg, lambda xe: xe, lambda ye: ye)


def _moe_sharded(p, x, cfg: ModelConfig):
    """:func:`moe_forward` on DTensors.  The expert products run on the
    expert rows laid out as JAX constrains them: experts on ``model``, every
    dispatch group on each rank of the other axes.

    A dispatch group never spans two sequences in training and prefill, so
    there each rank routes its own batch rows (top-k, capacity and the
    gathers both ways on local tensors), its expert rows are split to its
    experts and gathered over the batch's axes, and the products come back
    the same way; the load-balancing loss takes the batch-wide means.  A
    decode step's one group spans the batch: there ``x`` and the router are
    replicated and every rank routes the whole batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = [i for i, q in enumerate(x.placements)
             if isinstance(q, Shard) and q.dim == 0]
    if x.shape[1] == 1 or not batch:
        return _moe_replicated(p, x, cfg)
    x = redistribute(x, placements_for(x, {0}))
    rows = [Shard(1) if i in batch else Replicate()
            for i in range(mesh.ndim)]
    n = 1
    for i in batch:
        n *= mesh.size(i)

    def experts_layout(t):
        return spec_to_placements(guard_spec(logical_to_spec(
            ("experts", "expert_capacity", "embed")), t.shape, mesh), mesh)

    def to_experts(xe):
        xe = DTensor.from_local(xe, mesh, rows, run_check=False)
        target = experts_layout(xe)
        # split to this rank's experts first, then gather the groups
        xe = redistribute(xe, [t if isinstance(t, Shard) else r
                               for r, t in zip(rows, target)])
        return redistribute(xe, target)

    def from_experts(ye):
        target = experts_layout(ye)
        ye = redistribute(ye, target)
        ye = redistribute(ye, [r if isinstance(r, Shard) else t
                               for r, t in zip(rows, target)])
        return redistribute(ye, rows).to_local()

    def batch_mean(t):
        part = [Partial() if i in batch else Replicate()
                for i in range(mesh.ndim)]
        return replicated(DTensor.from_local(t / n, mesh, part,
                                             run_check=False)).to_local()

    router = replicated(p["router"]).to_local(
        grad_placements=[Partial() if i in batch else Replicate()
                         for i in range(mesh.ndim)])
    out, aux = _moe(dict(p, router=router), x.to_local(), cfg, to_experts,
                    from_experts, batch_mean)
    out = DTensor.from_local(out, mesh, x.placements, run_check=False)
    return (constrain(out, ("batch", "seq", "embed")),
            as_replicated(aux, mesh))


def _moe_replicated(p, x, cfg: ModelConfig):
    """:func:`_moe_sharded`'s decode path: the whole batch routed on every
    rank."""
    mesh = x.device_mesh

    def to_experts(xe):
        xe = as_replicated(xe, mesh)
        return constrain(xe, ("experts", "expert_capacity", "embed"))

    def from_experts(ye):
        ye = constrain(ye, ("experts", "expert_capacity", "embed"))
        return replicated(ye).to_local()

    params = dict(p, router=replicated(p["router"]).to_local())
    out, aux = _moe(params, replicated(x).to_local(), cfg, to_experts,
                    from_experts)
    out = constrain(as_replicated(out, mesh), ("batch", "seq", "embed"))
    return out, as_replicated(aux, mesh)


def _moe(p, x, cfg: ModelConfig, to_experts, from_experts,
         batch_mean=lambda t: t):
    """The MoE layer with ``to_experts`` applied to the dispatched expert
    rows (E, G_count * C, D), ``from_experts`` to the products' rows before
    the combine and ``batch_mean`` to the load-balancing loss's per-expert
    means over the groups (identities on plain tensors)."""
    dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if s >= MOE_GROUP and s % MOE_GROUP == 0:
        g_count, g = b * (s // MOE_GROUP), MOE_GROUP
    elif s == 1:
        g_count, g = 1, b       # decode: one group across the batch
    else:
        g_count, g = b, s
    xt = x.reshape(g_count, g, d)
    with trace.range("moe.route"):
        logits = (xt @ p["router"].to(dtype)).to(torch.float32)  # (B,G,E)
        probs = torch.softmax(logits, dim=-1)
        gate_idx = top_k_indices(probs.detach(), k)              # (B,G,k)
        onehot = F.one_hot(gate_idx, e).to(torch.int32)          # (B,G,k,E)
        # the chosen probabilities, by a product whose gradient is
        # elementwise
        gate_vals = (probs[..., None, :] * onehot).sum(-1)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        cap = max(int(math.ceil(g * k / e * cfg.capacity_factor)), 4)
        # each pair's slot in its expert: the pairs before it, token-major
        # (an integer scan along the innermost axis)
        seen = onehot.reshape(g_count, g * k, e).transpose(1, 2).cumsum(
            -1, dtype=torch.int32).transpose(1, 2).reshape(onehot.shape)
        pos = (seen * onehot).sum(-1) - 1
        keep = pos < cap
        if route_log is not None:
            route_log.append({"experts": gate_idx, "keep": keep,
                              "probs": probs.detach()})
        dev = x.device
        n_tok, n_slot = g_count * g, e * g_count * cap
        # slot id (expert, group, position): the expert rows are
        # contiguous; a dropped pair's slot is the sentinel n_slot
        group = torch.arange(g_count, device=dev)[:, None, None]
        slot = torch.where(keep, (gate_idx * g_count + group) * cap + pos,
                           n_slot).reshape(n_tok, k)
        # the inverse map, by gathers: a group's pairs sorted by expert
        # (stable, so token-major within one) put the pair of slot
        # (e, group, c) at expert e's start + c, where c < the pairs that
        # chose e
        order = torch.sort(gate_idx.reshape(g_count, g * k), dim=1,
                           stable=True)[1]
        counts = onehot.sum(dim=(1, 2))                          # (B, E)
        c = torch.arange(cap, device=dev)
        at = (counts.cumsum(-1) - counts)[..., None] + c         # (B,E,C)
        pair_at = torch.gather(order, 1, at.clamp(max=g * k - 1).reshape(
            g_count, e * cap)).reshape(g_count, e, cap) + group * (g * k)
        pair_at = torch.where(c < counts[..., None], pair_at, n_tok * k)
        pair_at = pair_at.transpose(0, 1).reshape(n_slot)
        token_at = torch.where(pair_at < n_tok * k, pair_at // k, n_tok)
    # the gathers copy values, so they run in the compute dtype; the
    # gradients' sums run in fp32, as JAX's fp32 dispatch einsum's
    with trace.range("moe.dispatch"):
        xe = to_experts(moe_rows.dispatch(xt.reshape(n_tok, d), slot,
                                          token_at).reshape(e, g_count * cap,
                                                            d))
    with trace.range("moe.experts"):
        gate = F.silu(torch.bmm(xe, p["w_gate"].to(dtype)))
        up = torch.bmm(xe, p["w_up"].to(dtype))
        ye = torch.bmm(gate * up, p["w_down"].to(dtype))
    with trace.range("moe.combine"):
        out = moe_rows.combine(from_experts(ye).reshape(n_slot, d),
                               gate_vals, slot, token_at, pair_at)
    # load-balancing auxiliary loss (Switch)
    with trace.range("moe.route"):
        me = batch_mean(probs.mean(dim=(0, 1)))
        ce = batch_mean(onehot.sum(2).to(torch.float32).mean(dim=(0, 1)))
        aux = e * (me * ce).sum()
    return out.reshape(b, s, d), aux
