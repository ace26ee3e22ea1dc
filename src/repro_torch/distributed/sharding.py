"""Logical-axis sharding rules on ``torch.distributed`` DTensors
(counterpart of ``repro.distributed.sharding``).

Model code annotates activations with *logical* axis names::

    x = constrain(x, ("batch", "seq", "embed"))

Inside a ``use_rules(mesh, rules)`` scope these map to mesh axes and
``constrain`` redistributes the DTensor to that layout (JAX's
``with_sharding_constraint``, made eager); outside any scope it returns its
input, so the same model runs on plain tensors (one device, the tests) and
on DTensors over a ``DeviceMesh``.  Inside a scope the model's plain
tensors (positions, masks) count as replicated
(``implicit_replication``), but ``constrain`` refuses one: an annotated
activation that is not a DTensor means the inputs were never laid out.

A spec (:class:`PartitionSpec`) names, per tensor dimension, ``None``
(replicated), a mesh axis, or a tuple of mesh axes that split the
dimension in that order, major first.  :func:`spec_to_placements` turns it
into DTensor placements, one per mesh dimension: ``("data", "model")`` on a
``("data", "model")`` mesh is ``[Shard(0), Shard(1)]`` (an axis of extent 1
is ``Replicate()``, the same layout); a dimension named
``("pod", "data")`` is ``Shard(d)`` on both, which DTensor splits over
``pod`` first and then ``data`` within each piece, so the rank at
coordinates ``(p, d)`` holds chunk ``p * |data| + d``, the chunk JAX's
``NamedSharding`` gives it.  A mesh axis named by two dimensions raises,
as JAX does.

Spec functions take a ``DeviceMesh`` or a :class:`MeshShape` (axis names
and extents only), so the production layouts can be computed without a
process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import zeros as _zeros
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

__all__ = ["DEFAULT_RULES", "MeshShape", "P", "PartitionSpec", "constrain",
           "current_mesh", "current_rules", "guard_spec", "logical_to_spec",
           "mesh_extents", "spec_to_placements", "use_rules"]

_state = threading.local()

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    # sequence-parallel residual stream between blocks (Megatron-SP)
    "seq_resid": "model",
    "kv_seq": "model",        # sequence-sharded KV cache (flash-decoding)
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",           # d_ff tensor parallel
    "vocab": "model",
    "experts": "model",       # expert parallel
    "expert_capacity": None,
    "fsdp": "data",           # secondary param shard axis
    "frames": None,
    "lru": "model",
}


class PartitionSpec(tuple):
    """Per tensor dimension: ``None``, a mesh-axis name or a tuple of
    names (JAX's ``PartitionSpec`` as a plain tuple)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and extents, without devices or ranks."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]


def mesh_extents(mesh) -> dict[str, int]:
    """Axis name -> extent of a ``DeviceMesh`` or a :class:`MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None = None):
    """Map logical axes onto ``mesh`` inside the block (``rules`` override
    :data:`DEFAULT_RULES`).  With a ``DeviceMesh`` the block also treats
    plain tensors met by DTensor ops as replicated."""
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", DEFAULT_RULES)
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                stack.enter_context(implicit_replication())
            yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


def logical_to_spec(logical_axes: tuple[str | None, ...],
                    rules: dict | None = None, mesh=None) -> PartitionSpec:
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    axis_names = set(mesh_extents(mesh)) if mesh is not None else set()
    parts = []
    for ax in logical_axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            parts.append(None)
        elif isinstance(m, tuple):
            kept = tuple(a for a in m if a in axis_names)
            parts.append(kept if kept else None)
        else:
            parts.append(m if m in axis_names else None)
    return P(*parts)


def _extent(part, ext: dict[str, int]) -> int:
    size = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        size *= ext[a]
    return size


def guard_spec(spec, shape, mesh) -> PartitionSpec:
    """``spec`` padded to ``len(shape)`` dims, with each axis whose extent
    does not divide its dimension replaced by replication (JAX's guard in
    ``constrain``: batch 1 at long_500k, whisper's 1500 frames)."""
    ext = mesh_extents(mesh)
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*[None if p is None or dim % _extent(p, ext) else p
               for dim, p in zip(shape, parts)])


def spec_to_placements(spec, mesh) -> list:
    """DTensor placements (one per mesh dimension) of ``spec`` on
    ``mesh``: ``Shard(d)`` on each mesh axis that tensor dimension ``d``
    names, ``Replicate()`` on the others.  An axis of extent 1 is
    ``Replicate()`` either way (the same layout: every rank of it holds the
    whole dimension), which keeps DTensor's view rules, which refuse to
    merge a dimension sharded over one rank, out of the debug mesh."""
    ext = mesh_extents(mesh)
    names = list(ext)
    owner: dict[str, int] = {}
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"{spec}: dimension {d} splits over {axes} against the mesh "
                f"order {tuple(names)}")
        for a in axes:
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} shards dimensions "
                                 f"{owner[a]} and {d}")
            owner[a] = d
    return [Shard(owner[n]) if n in owner and ext[n] > 1 else Replicate()
            for n in names]


def constrain(x, logical_axes: tuple[str | None, ...]):
    """Redistribute ``x`` to the layout of ``logical_axes`` inside a mesh
    scope (an axis that does not divide its dimension replicates), else
    return ``x`` itself.  Under autograd the gradient takes the same
    layout (:class:`_Constrain`)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(logical_axes)} inside a mesh scope "
                        f"got a {type(x).__name__}, not a DTensor")
    spec = guard_spec(logical_to_spec(logical_axes), x.shape, mesh)
    placements = spec_to_placements(spec, mesh)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, tuple(placements))
    return redistribute(x, placements)


class _Constrain(torch.autograd.Function):
    """The layout constraint on a value and on its gradient, as JAX
    transposes ``with_sharding_constraint``: a partial sum arriving at the
    constrained activation is reduced there, not carried into the next
    product (where DTensor would rather gather the weight and repeat the
    product on every rank)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return redistribute(x, list(placements))

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, list(ctx.placements)), None


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local_bounds(x) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of DTensor ``x``:
    each ``Shard(d)`` splits dimension ``d``'s current extent into
    ``torch.chunk`` pieces, mesh dimensions in order (DTensor's layout).
    Host arithmetic only, so it also runs on fake tensors."""
    coord = x.device_mesh.get_coordinate()
    shape, off = list(x.shape), [0] * x.ndim
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n, m = shape[p.dim], x.device_mesh.size(i)
            piece = -(-n // m)
            start = min(coord[i] * piece, n)
            shape[p.dim] = min(start + piece, n) - start
            off[p.dim] += start
    return tuple(shape), tuple(off)


def placements_for(x, dims_kept) -> list:
    """``x``'s placements with every ``Shard(d)`` whose ``d`` is not in
    ``dims_kept`` (and every partial sum) made ``Replicate()``."""
    return [p if isinstance(p, Shard) and p.dim in dims_kept else Replicate()
            for p in x.placements]


def fsdp_gathered(w):
    """DTensor ``w`` with its shards over the batch's mesh axes (``pod``,
    ``data``: FSDP / ZeRO) gathered and its other shards kept: a weight as
    a layer uses it, the layout of JAX's ZeRO-1 live params.  The product
    then runs on each rank's batch rows; the weight's gradient comes back
    as a partial sum that its layout's backward reduce-scatters."""
    if not is_dtensor(w):
        return w
    batch = current_rules().get("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    names = w.device_mesh.mesh_dim_names
    return redistribute(w, [Replicate() if names[i] in batch else p
                            for i, p in enumerate(w.placements)])


def host_view(t):
    """``t`` whole on this rank: a DTensor's ``full_tensor()``, else
    ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def reduced(x):
    """DTensor ``x`` with each partial sum reduced (replicated on those
    mesh axes, its shards kept)."""
    return redistribute(x, [Replicate() if p.is_partial() else p
                            for p in x.placements])


def redistribute(x, placements):
    """``x`` at ``placements`` (itself when it already is)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def write_slice(dst, index: tuple, src) -> None:
    """``dst[index] = src`` for basic ``index`` (ints and step-1 slices on
    leading dims).  With a DTensor ``dst`` each rank writes, into its own
    shard, the part of ``src`` that falls there: ``src`` is first laid out
    like ``dst`` on every dimension that the index keeps whole, and
    replicated on the others."""
    if not is_dtensor(dst):
        dst[index] = src
        return
    index = tuple(index) + (slice(None),) * (dst.ndim - len(index))
    ranges, dim_map = [], {}
    for d, (ix, n) in enumerate(zip(index, dst.shape)):
        if isinstance(ix, int):
            ranges.append((ix % n, ix % n + 1, False))
        else:
            a, b, step = ix.indices(n)
            if step != 1:
                raise ValueError(f"write_slice takes step-1 slices: {ix}")
            dim_map[len(dim_map)] = d
            ranges.append((a, b, True))
    inv = {d: j for j, d in dim_map.items()}
    want = [Shard(inv[p.dim]) if isinstance(p, Shard) and p.dim in inv
            and ranges[p.dim][:2] == (0, dst.shape[p.dim]) else Replicate()
            for p in dst.placements]
    if is_dtensor(src):
        src_local = redistribute(src, want).to_local()
    else:
        src_local, want = src, None
    shape, off = local_bounds(dst)
    dst_ix, src_ix = [], []
    src_dim = 0
    for d, (a, b, kept) in enumerate(ranges):
        lo, hi = max(a, off[d]), min(b, off[d] + shape[d])
        if lo >= hi:
            return
        dst_ix.append(slice(lo - off[d], hi - off[d]) if kept
                      else lo - off[d])
        if kept:
            sharded = want is not None and any(
                isinstance(p, Shard) and p.dim == src_dim for p in want)
            base = off[d] if sharded else a
            src_ix.append(slice(lo - base, hi - base))
            src_dim += 1
    local = dst.to_local()
    local[tuple(dst_ix)] = src_local[tuple(src_ix)].to(local.dtype)


def batch_grad(placements) -> list:
    """The gradient placements of an input replicated beside inputs laid
    out by ``placements``: a partial sum over each mesh axis that splits
    them (every rank's share covers its own rows only)."""
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in placements]


def local_call(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` on each rank's local shards (``local_map``): each DTensor of
    ``args`` is first redistributed to its entry of ``in_placements``; the
    results are DTensors at ``out_placements``.  Differentiable; an input's
    gradient comes back at its ``grad_placements`` entry (default: its
    placements)."""
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = [redistribute(a, pl) if is_dtensor(a) else a
            for a, pl in zip(args, in_placements)]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     device_mesh=mesh)(*args)


def replicated(x):
    """DTensor ``x`` replicated on every mesh axis (the whole tensor on
    each rank)."""
    return redistribute(x, [Replicate()] * x.device_mesh.ndim)


def as_replicated(local, mesh):
    """A tensor that every rank holds whole, as a replicated DTensor."""
    return DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _aligned_to(x, dst, dim_map: dict[int, int]):
    """``x`` (DTensor or plain, every rank the same) laid out like ``dst``
    on ``dst``'s dims ``dim_map`` (x dim -> dst dim), replicated on the
    others; returns its local tensor."""
    inv = {d: j for j, d in dim_map.items()}
    want = [Shard(inv[p.dim]) if isinstance(p, Shard) and p.dim in inv
            else Replicate() for p in dst.placements]
    if not is_dtensor(x):
        x = as_replicated(x, dst.device_mesh)
    return redistribute(x, want).to_local()


def commit_rows(leaf, index: tuple, new, rows) -> None:
    """``leaf[index]`` (batch first after the integer ``index``) takes the
    rows ``rows`` (global batch rows; None: every row) of ``new``, in
    place.  With a DTensor ``leaf`` each rank writes its own rows of its
    own shard, so the leaf keeps its placements."""
    k = len(index)
    dst = leaf.to_local()[index]
    new_l = _aligned_to(new, leaf, {j: j + k for j in range(new.ndim)})
    shape, off = local_bounds(leaf)
    if rows is None:
        dst.copy_(new_l.to(dst.dtype))
        return
    b0, nb = off[k], shape[k]
    r = rows[(rows >= b0) & (rows < b0 + nb)] - b0
    dst.index_copy_(0, r, new_l.index_select(0, r).to(dst.dtype))


def put_rows(dst, rows, slots, src) -> None:
    """``dst[r, slots[r]] = src[r]`` for the global batch rows ``rows``
    (None: every row) of DTensor ``dst`` (B, S, ...), ``slots`` (B,) the
    sequence position of each row, ``src`` (B, ...).  Each rank writes the
    entries that fall in its shard; the shapes do not depend on the data
    (a row left out rewrites its old entry), so a fake tensor traces it."""
    shape, off = local_bounds(dst)
    b0, nb, s0, ns = off[0], shape[0], off[1], shape[1]
    local = dst.to_local()
    src_l = _aligned_to(src, dst, {0: 0})
    dev = local.device
    i = torch.arange(nb, device=dev)
    col = slots.to(dev)[b0:b0 + nb] - s0
    keep = (col >= 0) & (col < ns)
    if rows is not None:
        sel = torch.zeros(dst.shape[0], dtype=torch.bool, device=dev)
        sel[rows.to(dev)] = True
        keep = keep & sel[b0:b0 + nb]
    c = col.clamp(0, ns - 1)
    old = local[i, c]
    pick = keep.reshape(nb, *([1] * (old.ndim - 1)))
    local[i, c] = torch.where(pick, src_l.to(local.dtype), old)


def dtensor_zeros(shape, dtype, mesh, placements):
    """Zeros of global ``shape`` at ``placements`` on ``mesh``; each rank
    allocates only its shard."""
    return _zeros(*shape, dtype=dtype, device_mesh=mesh,
                  placements=placements)


def split_dim(t, dim: int, *sizes):
    """``t`` with dimension ``dim`` split into ``sizes``.  A DTensor whose
    ``dim`` is split over mesh axes that do not divide ``sizes[0]`` (16
    ranks over 8 KV heads) is first gathered on those axes."""
    dim = dim % t.ndim
    if is_dtensor(t):
        m = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == dim:
                m *= t.device_mesh.size(i)
        if sizes[0] % m:
            t = redistribute(t, [
                Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in t.placements])
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def split_last(t, *sizes):
    """``t`` with its last dimension split into ``sizes``
    (:func:`split_dim`)."""
    return split_dim(t, -1, *sizes)


def vocab_lookup(tokens, table):
    """``F.embedding(tokens, table)`` for a DTensor ``table`` whose rows
    (the vocabulary) may be split over mesh axes: each rank looks up the
    tokens that fall in its rows and the partial results are summed over
    those axes; the tokens keep their batch layout.  The table is first
    gathered along its embedding dimension (FSDP)."""
    table = redistribute(table, placements_for(table, {0}))
    if not is_dtensor(tokens):
        tokens = as_replicated(tokens, table.device_mesh)
    tok_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
              and not isinstance(q, Shard) else Replicate()
              for p, q in zip(tokens.placements, table.placements)]
    out_pl = [Partial() if isinstance(q, Shard) else t
              for t, q in zip(tok_pl, table.placements)]
    grad_pl = [Partial() if isinstance(t, Shard) else q
               for t, q in zip(tok_pl, table.placements)]
    (_, _), (v0, _) = local_bounds(table)
    rows = local_bounds(table)[0][0]

    def lookup(ids, tbl):
        ids = ids.long() - v0
        keep = (ids >= 0) & (ids < rows)
        emb = F.embedding(ids.clamp(0, rows - 1), tbl)
        return torch.where(keep[..., None], emb, torch.zeros_like(emb))

    out = local_call(lookup, (tokens, table), (tok_pl, table.placements),
                     out_pl, (tok_pl, grad_pl))
    return reduced(out)


class _GradAt(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the input was."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, list(ctx.placements))


def merge_last(t, n: int):
    """``t`` with its last ``n`` dimensions merged into one.  On a DTensor
    the gradient arriving at the merged tensor is first laid out as the
    merged tensor was, so that the backward's split of it divides (a
    gradient split over 16 ranks cannot be unflattened into 56 heads)."""
    t = t.reshape(*t.shape[:-n], -1)
    return _GradAt.apply(t) if is_dtensor(t) else t
