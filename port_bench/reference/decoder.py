"""Plain fp32 reference of the decoder-only models the benchmark trains.

Written from the published descriptions, in plain ``torch`` operations,
with TF32 off; it imports nothing of the program.  It follows what the
configuration file states:

- embedding lookup; per layer a pre-norm block: norm, causal multi-head
  attention with grouped K/V heads (head ``h`` reads K/V head ``h // (H /
  KV)``) and half-split rotary positions, residual; norm, SwiGLU MLP or the
  MoE layer, residual; final norm; the output head (the embedding's
  transpose when tied); mean next-token cross-entropy over the loss mask;
- norms: ``nonparametric_ln`` (OLMo's LayerNorm without scale or bias) or
  ``rmsnorm`` with a scale, both at ``norm_eps``;
- the MoE layer as the configuration's ``departures`` state it: GShard
  dispatch in groups of ``moe_group`` tokens, each token's top ``top_k``
  router probabilities (equal values to the lower expert), a (token,
  choice) pair taking its expert's next slot in token-major order and
  dropped past ``max(ceil(G k / E * capacity_factor), 4)`` slots, each kept
  expert's SwiGLU output weighted by the sum of the token's renormalised
  gates, and ``aux_coef`` times the Switch load-balancing loss (every
  choice counted, kept or not) added to the loss, a term a layer;
- AdamW (:func:`adamw_step`) as the traffic file's ``optimizer`` states it.

The MoE layer's top-k choice is a discrete decision: at a near-tie, the
program's bf16 router and this fp32 one may take different experts, and the
capacity's token-major slots carry one such flip on to other tokens, so that
two correct computations part further with every layer.  Given the
program's routes, the reference therefore follows them, and checks the
routing stage by itself: the gap by which an expert left out beats one
taken, in its own fp32 logits (:func:`_moe`).

A step runs layer by layer over the whole batch: a forward without
gradients keeps each layer's input, then the head and each layer from the
last are run again with gradients (one layer's activations at a time), so
the peak is a layer's, not the model's.  ``mm`` does every product with a
weight; :func:`fp8_mm` puts the products in fp8 (the control).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["exact_fp32", "plain_mm", "fp8_mm", "train_steps", "adamw_step",
           "lr_scale"]


def exact_fp32() -> None:
    """fp32 products in fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_mm(a, w):
    return a @ w


def _fp8(x, dtype):
    """``x`` rounded to ``dtype`` under one scale for the tensor (its
    largest magnitude at the format's largest value), back in fp32."""
    s = torch.finfo(dtype).max / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).to(torch.float32) / s


class _Fp8MM(torch.autograd.Function):
    """``a @ w`` from operands rounded to e4m3 and, in the backward, the
    output gradient rounded to e5m2: fp8 training's precision, with fp32
    sums."""

    @staticmethod
    def forward(ctx, a, w):
        a8, w8 = _fp8(a, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, w8)
        return a8 @ w8

    @staticmethod
    def backward(ctx, g):
        a8, w8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        da = g8 @ w8.T
        dw = a8.reshape(-1, a8.shape[-1]).T @ g8.reshape(-1, g8.shape[-1])
        return da, dw


def fp8_mm(a, w):
    return _Fp8MM.apply(a, w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _norm(m, x, scale=None):
    if m.norm_type == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + m.norm_eps) * scale
    if m.norm_type != "nonparametric_ln":
        raise NotImplementedError(m.norm_type)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + m.norm_eps)


def _rope(x, theta):
    """x (B, S, H, D) at positions 0..S-1: the first and second halves of
    each head rotated as pairs."""
    s, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(m, p, x, mm):
    b, s, _ = x.shape
    h, kv, hd = m.n_heads, m.n_kv_heads, m.head_dim
    q = _rope(mm(x, p["wq"]).view(b, s, h, hd), m.rope_theta)
    k = _rope(mm(x, p["wk"]).view(b, s, kv, hd), m.rope_theta)
    v = mm(x, p["wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, h * hd)
    return mm(o, p["wo"])


def _swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def _moe(m, p, x, mm, top=None):
    """(out, load-balancing loss, the routes used, their gap) of the MoE
    layer on x (B, S, D).  ``top`` (ng, g, k): the experts each token
    takes, in rank order, in place of the layer's own top k; their gap is
    by how much, in the router's logits, the best expert left out beats the
    worst taken, at a token (0 where the routes are a top k of these
    logits; infinite where ``top`` does not fit the batch)."""
    b, s, d = x.shape
    e, k, g = m.n_experts, m.top_k, m.moe_group
    xt = (x.reshape(b * s // g, g, d) if s >= g and s % g == 0 else x)
    ng, g = xt.shape[:2]
    logits = mm(xt, p["router"])                                 # (ng, g, E)
    probs = torch.softmax(logits, dim=-1)
    gap = 0.0
    if top is not None and tuple(top.shape) != (ng, g, k):
        top, gap = None, float("inf")
    if top is None:
        top = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[..., :k]           # (ng, g, k)
    else:
        lg = logits.detach()
        worst_in = torch.gather(lg, -1, top).amin(-1)
        best_out = lg.scatter(-1, top, float("-inf")).amax(-1)
        gap = float((best_out - worst_in).clamp(min=0).amax())
    chosen = torch.gather(probs, -1, top)
    gates = chosen / chosen.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(math.ceil(g * k / e * m.capacity_factor), 4)
    onehot = F.one_hot(top, e)                                   # (ng,g,k,E)
    flat = onehot.reshape(ng, g * k, e)
    slot = ((flat.cumsum(1) * flat).sum(-1) - 1).reshape(ng, g, k)
    kept = slot < cap
    weight = gates.sum(-1).reshape(-1)                           # (ng g,)
    xf = xt.reshape(-1, d)
    top_f, kept_f = top.reshape(-1, k), kept.reshape(-1, k)
    y = torch.zeros_like(xf)
    for ex in range(e):
        rows = ((top_f == ex) & kept_f).any(-1).nonzero().squeeze(1)
        if rows.numel():
            ye = _swiglu(xf[rows], p["w_gate"][ex], p["w_up"][ex],
                         p["w_down"][ex], mm)
            y = y.index_add(0, rows, ye * weight[rows, None])
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(2).to(torch.float32).mean(dim=(0, 1))
    return y.reshape(b, s, d), e * (me * ce).sum(), top, gap


def _block(m, p, x, mm, top=None):
    """(x after the layer, its load-balancing loss, routes, gap: 0, None,
    0 without experts)."""
    h = _norm(m, x, p.get("ln1", {}).get("scale"))
    x = x + _attention(m, p["attn"], h, mm)
    h = _norm(m, x, p.get("ln2", {}).get("scale"))
    if m.is_moe:
        out, aux, top, gap = _moe(m, p["moe"], h, mm, top)
        return x + out, aux, top, gap
    mp = p["mlp"]
    out = _swiglu(h, mp["w_gate"], mp["w_up"], mp["w_down"], mm)
    return x + out, x.new_zeros(()), None, 0.0


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        v, path = tree[key], f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        else:
            out[path] = v
    return out


def _layer_leaves(params, layer: int, grad: bool) -> dict:
    """Layer ``layer``'s slices of the stacked leaves, as a tree (leaves
    that want a gradient with ``grad``)."""
    def take(t):
        t = t[layer].detach()
        return t.requires_grad_() if grad else t

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else take(v)
                for k, v in node.items()}
    return walk(params["layers"])


def loss_and_grads(m, params, batch, mm=plain_mm, routes=None):
    """(loss, fp32 gradient tree of ``params``, the routes of each MoE
    layer, their largest gap) of one batch (tensors on the params' device);
    ``routes`` (a layer's (ng, g, k) experts each) in place of the layers'
    own top k (:func:`_moe`)."""
    tokens = batch["tokens"].long()
    targets = batch["targets"].long()
    mask = batch["loss_mask"].to(torch.float32)
    b = tokens.shape[0]
    grads = {p: torch.zeros_like(t) for p, t in _flat(params).items()}
    with torch.no_grad():
        x = params["embed"][tokens]
        inputs, used, gap = [], [], 0.0
        for layer in range(m.n_layers):
            inputs.append(x)
            x, _, top, g = _block(m, _layer_leaves(params, layer, False), x,
                                  mm, routes[layer] if routes else None)
            used.append(top)
            gap = max(gap, g)
    # the head, a sequence at a time: the mean over every counted token
    x_last = x.detach().requires_grad_()
    w_embed = params["embed"].detach().requires_grad_()
    w_out = (w_embed.T if m.tie_embeddings
             else params["lm_head"].detach().requires_grad_())
    fscale = params.get("final_norm", {}).get("scale")
    fscale = fscale.detach().requires_grad_() if fscale is not None else None
    count = mask.sum()
    xent = 0.0
    for r in range(b):
        logits = mm(_norm(m, x_last[r], fscale), w_out)
        gold = torch.gather(logits, -1, targets[r][:, None])[:, 0]
        part = ((torch.logsumexp(logits, -1) - gold) * mask[r]).sum() / count
        part.backward()
        xent += float(part.detach())
    grads["embed"] += w_embed.grad
    if not m.tie_embeddings:
        grads["lm_head"] += params["lm_head"].grad
    if fscale is not None:
        grads["final_norm/scale"] += fscale.grad
    dx, aux_sum = x_last.grad, 0.0
    for layer in reversed(range(m.n_layers)):
        xin = inputs.pop().requires_grad_()
        leaves = _layer_leaves(params, layer, True)
        out, aux, _, _ = _block(m, leaves, xin, mm, used[layer])
        if m.is_moe:
            torch.autograd.backward([out, m.aux_coef * aux],
                                    [dx, torch.ones_like(aux)])
        else:
            out.backward(dx)
        aux_sum += float(aux.detach())
        for path, leaf in _flat(leaves, "layers/").items():
            grads[path][layer] += leaf.grad
        dx = xin.grad
    grads["embed"].index_add_(0, tokens.reshape(-1),
                              dx.reshape(-1, dx.shape[-1]))
    return xent + m.aux_coef * aux_sum, grads, used, gap


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def lr_scale(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine to ``min_frac``
    at ``total_steps``; ``step`` counts the updates made before this one."""
    warm = min(step / max(opt["warmup"], 1), 1.0)
    prog = min(max((step - opt["warmup"])
                   / max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
    cos = opt["min_frac"] + (1 - opt["min_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return warm * cos


def _decays(opt: dict, path: str) -> bool:
    last = path.rsplit("/", 1)[-1]
    return not any(s in last for s in opt["no_decay_substrings"])


def adamw_step(opt: dict, params: dict, grads: dict, state: dict):
    """One AdamW update in place of flat ``params`` and ``state`` (``mu``,
    ``nu``: flat dicts; ``step``: updates made), gradients clipped to
    ``grad_clip`` by their global norm first.  Returns the clipped
    gradients."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g, dtype=torch.float64))
                          for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
    t = state["step"] + 1
    b1, b2 = opt["b1"], opt["b2"]
    lr = opt["lr"] * lr_scale(opt, state["step"])
    clipped = {}
    for path, p in params.items():
        g = grads[path] * scale
        clipped[path] = g
        mu = state["mu"][path].mul_(b1).add_(g, alpha=1 - b1)
        nu = state["nu"][path].mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                         + opt["eps"])
        if _decays(opt, path):
            update = update + opt["weight_decay"] * p
        p.sub_(lr * update)
    state["step"] = t
    return clipped


def train_steps(m, opt: dict, params: dict, batches, mm=plain_mm,
                routes=None):
    """Run AdamW steps from ``params`` (a tree, updated in place) on
    ``batches`` (each step's MoE layers on ``routes[step]`` where given);
    returns each step's loss, the norm of each leaf's first clipped
    gradient, the routes each step used and their largest gap."""
    flat = _flat(params)
    state = {"mu": {p: torch.zeros_like(t) for p, t in flat.items()},
             "nu": {p: torch.zeros_like(t) for p, t in flat.items()},
             "step": 0}
    losses, first, used, gap = [], None, [], 0.0
    for i, batch in enumerate(batches):
        loss, grads, tops, g = loss_and_grads(
            m, params, batch, mm, routes[i] if routes else None)
        losses.append(loss)
        used.append(tops)
        gap = max(gap, g)
        clipped = adamw_step(opt, flat, grads, state)
        if first is None:
            first = {p: float(torch.linalg.vector_norm(g))
                     for p, g in clipped.items()}
        del grads, clipped
    return losses, first, used, gap
