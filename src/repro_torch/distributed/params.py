"""Parameter / optimizer / batch / cache specs for the production mesh
(counterpart of ``repro.distributed.params``), and the placement of the
port's trees on a ``DeviceMesh`` as DTensors.

Strategy (TP on ``model``, ZeRO/FSDP on ``data``, DP across ``pod``):

* attention / MLP projections: input dim on ``data`` (FSDP), output dim on
  ``model`` (Megatron column-parallel); down/out projections transposed
  (row-parallel).
* MoE expert weights: experts on ``model`` (EP), input dim on ``data``.
* embeddings / lm_head: vocab on ``model``, embed dim on ``data``.
* RG-LRU / RWKV channel dims on ``model``; norms and scalar gains replicated.
* KV caches: batch on ``data``, sequence on ``model`` (flash-decoding style
  split -- GQA head counts rarely divide 16, sequence always does).
* optimizer moments: identical specs to their parameters.

Any dimension that does not divide its mesh axis falls back to replication
(granite-moe's vocab 49155, long_500k's batch 1).  The trees are the port's
nested dicts, walked in :func:`repro_torch.tree.flatten`'s order (JAX's);
a leaf is anything with ``shape`` and ``ndim`` (a meta tensor will do).
"""
from __future__ import annotations

from ..models.config import ModelConfig
from ..tree import flatten, tree_map, unflatten
from .sharding import (P, dtensor_zeros, is_dtensor, mesh_extents,
                       redistribute, spec_to_placements)

__all__ = ["batch_specs", "cache_specs", "distribute_opt_state",
           "distribute_params", "distribute_tree", "init_cache_sharded",
           "opt_state_specs", "param_shardings", "param_specs",
           "spec_for_param", "tree_placements"]

# trailing-dims spec by (parent, leaf-name); "." matches any parent
_RULES: dict[tuple[str, str], tuple] = {
    (".", "embed"): ("model", "data"),
    (".", "lm_head"): ("data", "model"),
    (".", "enc_pos"): (None, None),
    (".", "dec_pos"): (None, None),
    # attention
    ("attn", "wq"): ("data", "model"),
    ("attn", "wk"): ("data", "model"),
    ("attn", "wv"): ("data", "model"),
    ("attn", "wo"): ("model", "data"),
    ("attn", "bq"): ("model",),
    ("attn", "bk"): ("model",),
    ("attn", "bv"): ("model",),
    ("attn", "bo"): (None,),
    ("xattn", "wq"): ("data", "model"),
    ("xattn", "wk"): ("data", "model"),
    ("xattn", "wv"): ("data", "model"),
    ("xattn", "wo"): ("model", "data"),
    ("xattn", "bq"): ("model",),
    ("xattn", "bk"): ("model",),
    ("xattn", "bv"): ("model",),
    ("xattn", "bo"): (None,),
    # dense MLP
    ("mlp", "w_gate"): ("data", "model"),
    ("mlp", "w_up"): ("data", "model"),
    ("mlp", "w_down"): ("model", "data"),
    ("mlp", "b_up"): ("model",),
    ("mlp", "b_down"): (None,),
    # MoE
    ("moe", "router"): ("data", None),
    ("moe", "w_gate"): ("model", "data", None),
    ("moe", "w_up"): ("model", "data", None),
    ("moe", "w_down"): ("model", None, "data"),
    # RG-LRU recurrent branch
    ("rec", "w_gate_branch"): ("data", "model"),
    ("rec", "w_rec_branch"): ("data", "model"),
    ("rec", "conv_w"): (None, "model"),
    ("rec", "conv_b"): ("model",),
    ("rec", "wa"): ("data", "model"),
    ("rec", "wx"): ("data", "model"),
    ("rec", "ba"): ("model",),
    ("rec", "bx"): ("model",),
    ("rec", "lam"): ("model",),
    ("rec", "w_out"): ("model", "data"),
    # RWKV time-mix
    ("tm", "wr"): ("data", "model"),
    ("tm", "wk"): ("data", "model"),
    ("tm", "wv"): ("data", "model"),
    ("tm", "wg"): ("data", "model"),
    ("tm", "wo"): ("model", "data"),
    ("tm", "lora_a"): ("data", None),
    ("tm", "lora_b"): (None, None, "data"),
    ("tm", "w_lora_a"): ("data", None),
    ("tm", "w_lora_b"): (None, "data"),
    ("tm", "mu"): (None, None),
    ("tm", "ww"): (None,),
    ("tm", "u"): (None,),
    ("tm", "ln_scale"): (None,),
    # RWKV channel-mix
    ("cm", "wk"): ("data", "model"),
    ("cm", "wv"): ("model", "data"),
    ("cm", "wr"): ("data", "model"),
    ("cm", "mu_k"): (None,),
    ("cm", "mu_r"): (None,),
}


def _divisible(dim: int, axes, mesh) -> bool:
    if axes is None:
        return True
    ext = mesh_extents(mesh)
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= ext[a]
    return dim % size == 0


def _guard(parts, shape, mesh) -> P:
    """Drop the axes a dimension cannot divide (replication)."""
    return P(*[a if _divisible(shape[i], a, mesh) else None
               for i, a in enumerate(parts)])


def spec_for_param(path, leaf, mesh) -> P:
    names = [str(n) for n in path if str(n)]
    leaf_name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else "."
    rule = _RULES.get((parent, leaf_name)) or _RULES.get((".", leaf_name))
    if rule is None:
        # norms (ln1/ln2/...), scalar gains: replicate
        return P(*([None] * leaf.ndim))
    parts = [None] * (leaf.ndim - len(rule)) + list(rule)
    return _guard(parts, leaf.shape, mesh)


def _strip_data(spec: P) -> P:
    """ZeRO-1 live params: TP on `model` only, replicated over `data`."""
    return P(*[None if p == "data" else p for p in spec])


def _map_with_path(fn, tree):
    return unflatten(tree, [fn(path, leaf) for path, leaf in flatten(tree)])


def param_specs(abstract_params, mesh, *, zero1: bool = False):
    full = _map_with_path(lambda path, leaf: spec_for_param(path, leaf, mesh),
                          abstract_params)
    return tree_map(_strip_data, full) if zero1 else full


def tree_placements(specs, mesh):
    """Each spec of ``specs`` as DTensor placements on ``mesh``."""
    return tree_map(lambda s: spec_to_placements(s, mesh), specs)


def param_shardings(abstract_params, mesh, *, zero1: bool = False):
    """:func:`param_specs` as placements on the ``DeviceMesh`` (the
    counterpart of JAX's ``NamedSharding`` tree)."""
    return tree_placements(param_specs(abstract_params, mesh, zero1=zero1),
                           mesh)


def opt_state_specs(abstract_opt, abstract_params, mesh, *,
                    zero1: bool = False):
    """Moments (and the fp32 master copy under ZeRO-1) always keep the full
    data+model sharding -- that is what ZeRO-1 shards."""
    del zero1
    pspec = param_specs(abstract_params, mesh)      # full sharding
    out = {"mu": pspec, "nu": pspec, "step": P()}
    if "master" in abstract_opt:
        out["master"] = pspec
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(abstract_batch, mesh):
    """Leading dim = global batch on ("pod", "data")."""
    names = mesh_extents(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)

    def one(leaf):
        if leaf.ndim == 0:
            return P()
        if _divisible(leaf.shape[0], batch_axes, mesh):
            return P(batch_axes, *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return tree_map(one, abstract_batch)


def cache_specs(abstract_cache, cfg: ModelConfig, mesh):
    """KV caches: (L, B, S, KV, D) -> batch on data, seq on model.
    Recurrent states: channel dims on model."""
    del cfg

    def one(path, leaf):
        name = str(path[-1]) if path else ""
        if name in ("k", "v", "cross_k", "cross_v"):
            lead = leaf.ndim - 4                       # stacked layer axes
            parts = [None] * lead + ["data", "model", None, None]
        elif name == "S":                              # rwkv state (L,B,H,N,N)
            parts = [None, "data", "model", None, None]
        elif name in ("x_tm", "x_cm"):                 # (L, B, D)
            parts = [None, "data", "model"]
        elif name in ("h", "tail_h"):                  # (..., B, W)
            parts = [None] * (leaf.ndim - 2) + ["data", "model"]
        elif name in ("conv", "tail_conv"):            # (..., B, cw-1, W)
            parts = [None] * (leaf.ndim - 3) + ["data", None, "model"]
        else:
            parts = [None] * leaf.ndim
        return _guard(parts, leaf.shape, mesh)

    return _map_with_path(one, abstract_cache)


def init_cache_sharded(cfg: ModelConfig, batch: int, cache_len: int, mesh,
                       dtype=None):
    """``lm.init_cache``'s zero cache as DTensors laid out by
    :func:`cache_specs` on ``mesh``; each rank allocates its shard only."""
    import torch

    from ..models import lm
    meta = lm.init_cache(cfg, batch, cache_len,
                         dtype=dtype or torch.bfloat16, device="meta")
    specs = cache_specs(meta, cfg, mesh)
    return {k: dtensor_zeros(v.shape, v.dtype, mesh,
                             spec_to_placements(specs[k], mesh))
            for k, v in meta.items()}


def distribute_tree(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh`` under ``specs`` (a tree of
    :class:`~repro_torch.distributed.sharding.PartitionSpec` of the same
    structure): the counterpart of ``jax.device_put(tree, shardings)``.
    Every rank holds the same full tensor (the same seed or checkpoint), so
    each keeps its own chunk and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        placements = spec_to_placements(spec, mesh)
        if is_dtensor(t):
            return redistribute(t, placements)
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    return tree_map(one, tree, specs)


def distribute_params(params, mesh, *, zero1: bool = False):
    """The params as DTensors under :func:`param_specs`."""
    return distribute_tree(params, param_specs(params, mesh, zero1=zero1),
                           mesh)


def distribute_opt_state(state, params, mesh):
    """AdamW state as DTensors under :func:`opt_state_specs`; the step
    counter stays a host scalar (``P()``: the same on every rank)."""
    specs = opt_state_specs(state, params, mesh)
    out = {k: distribute_tree(v, specs[k], mesh)
           for k, v in state.items() if k != "step"}
    out["step"] = state["step"]
    return out
