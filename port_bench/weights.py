"""Seeded weights, made on the device.

The tree is the port's (and the JAX package's): nested dicts, layer leaves
stacked along a leading ``(n_layers, ...)`` axis, keys ``embed``,
``final_norm``, ``layers/{ln1,ln2,attn,mlp|moe}``.  Each leaf is drawn by a
generator of its own on the device, seeded from (``--seed``, the leaf's
path), in one call, in fp32 (the type training keeps): so any leaf can be
drawn again alone, as the comparison does for the parameters' change.
Dense leaves are a normal truncated to [-2, 2] over the square root of the
fan-in, as the port's ``dense_init``; norm scales are ones.  The tree of
an architecture is its reference module's ``leaf_specs`` hook where it has
one (:func:`specs`).
"""
from __future__ import annotations

import hashlib
import math

import torch

from . import arch
from .model import Model
from .traffic import SEED_MASK

__all__ = ["leaf_specs", "draw_leaf", "draw", "nest", "flat"]


def leaf_specs(m: Model) -> list[tuple[str, tuple | None, int]]:
    """[(path, shape, fan_in)] of the decoder-only llama tree, in a fixed
    order; ``fan_in`` 0 marks a norm scale (ones), ``shape`` None an empty
    node (a non-parametric norm)."""
    if m.block_type != "llama":
        raise NotImplementedError(f"block {m.block_type!r}")
    d, ff, L = m.d_model, m.d_ff, m.n_layers
    q, kv = m.n_heads * m.head_dim, m.n_kv_heads * m.head_dim
    specs = [("embed", (m.vocab_size, d), d)]
    if not m.tie_embeddings:
        specs.append(("lm_head", (d, m.vocab_size), d))
    if m.norm_type == "rmsnorm":
        specs += [("final_norm/scale", (d,), 0),
                  ("layers/ln1/scale", (L, d), 0),
                  ("layers/ln2/scale", (L, d), 0)]
    elif m.norm_type != "nonparametric_ln":
        raise NotImplementedError(f"norm {m.norm_type!r}")
    if m.use_bias:
        raise NotImplementedError("attention biases")
    specs += [("layers/attn/wq", (L, d, q), d), ("layers/attn/wk", (L, d, kv), d),
              ("layers/attn/wv", (L, d, kv), d), ("layers/attn/wo", (L, q, d), q)]
    if m.is_moe:
        e = m.n_experts
        specs += [("layers/moe/router", (L, d, e), d),
                  ("layers/moe/w_gate", (L, e, d, ff), d),
                  ("layers/moe/w_up", (L, e, d, ff), d),
                  ("layers/moe/w_down", (L, e, ff, d), ff)]
    else:
        specs += [("layers/mlp/w_gate", (L, d, ff), d),
                  ("layers/mlp/w_up", (L, d, ff), d),
                  ("layers/mlp/w_down", (L, ff, d), ff)]
    if m.norm_type == "nonparametric_ln":
        specs += [("final_norm", None, 0), ("layers/ln1", None, 0),
                  ("layers/ln2", None, 0)]
    return specs


def _leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{seed & SEED_MASK}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") & SEED_MASK


def draw_leaf(path: str, shape: tuple, fan_in: int, seed: int,
              device) -> torch.Tensor:
    """The fp32 leaf ``path`` of seed ``seed`` on ``device``."""
    if not fan_in:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return w.mul_(1.0 / math.sqrt(fan_in))


def nest(flat: dict) -> dict:
    """{"a/b": t} -> {"a": {"b": t}}; a path whose value is None becomes an
    empty dict (a non-parametric norm's node)."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = {} if t is None else t
    return out


def draw(m: Model, seed: int, device) -> dict:
    """The whole tree of seed ``seed``, as the program takes it."""
    return nest({p: None if s is None else draw_leaf(p, s, f, seed, device)
                 for p, s, f in arch.leaf_specs(m)})


def flat(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a tree of nested dicts (keys sorted)."""
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = v
    return out
