"""Per-rank collective bytes of one executed step (counterpart of
``repro.analysis.hlo``).

The JAX package parses the post-SPMD HLO text and scales each collective
inside a ``while`` body by its trip count.  The port runs eagerly: every
layer and microbatch executes, so the collectives are recorded as they are
issued.  :class:`CollectiveLog` is a ``TorchDispatchMode`` over the
functional collectives (``_c10d_functional.*``) that DTensor's
redistributions issue on each rank's local tensors; it keeps each result's
per-rank shape and dtype.  :func:`collective_totals` sums a log into JAX's
dict layout (``bytes``, ``counts``, ``bytes_f32``, ``scaled``), where
``scaled: True`` means "counted as executed" (nothing needs a trip-count
factor).  There is no HLO text to parse, so the parser is not ported.

Byte convention: the *result shape* of the op, per rank, as JAX records
it; :func:`link_bytes` converts to link traffic with the ring factors:
all-reduce ~ 2x, all-gather / reduce-scatter ~ 1x, all-to-all ~ 1x,
collective-permute ~ 1x.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["COLLECTIVES", "LINK_FACTOR", "CollectiveLog", "LocalOpMode",
           "collective_kind", "collective_totals", "link_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# effective link-bytes multipliers (ring algorithms)
LINK_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
    "permute_tensor": "collective-permute",
}


def collective_kind(func) -> str | None:
    """JAX's collective name of a ``_c10d_functional`` op (None for any
    other op, ``wait_tensor`` included)."""
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return None
    return _KINDS.get(func._overloadpacket.__name__)


#: depth of DTensor's global-shape propagation now running (a plain
#: counter, since the autograd engine may run a backward on another thread)
_propagating = [0]


@contextlib.contextmanager
def _meta_propagation():
    """Mark the ops DTensor runs to derive a result's global shape (on the
    ambient fake mode, when there is one): they are not the rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _propagating[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _propagating[0] -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode that sees each rank's local ops: a call on DTensors
    is passed on (``NotImplemented``), so DTensor runs it and its local ops
    and collectives come back through this mode, and the ops DTensor runs
    only to derive global shapes are skipped.  Subclasses implement
    :meth:`on_op`."""

    def __enter__(self):
        self._prop = _meta_propagation()
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)

    def on_op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _propagating[0]:
            self.on_op(func, args, kwargs, out)
        return out


class CollectiveLog(LocalOpMode):
    """Records ``(kind, shape, dtype)`` of every collective result."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, tuple[int, ...], torch.dtype]] = []

    def on_op(self, func, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind is None:
            return
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.records.append((kind, tuple(t.shape), t.dtype))


def collective_totals(log) -> dict:
    """Per-rank collective bytes and counts by kind (JAX's layout) of a
    :class:`CollectiveLog` or its ``records``."""
    records = getattr(log, "records", log)
    b = {c: 0 for c in COLLECTIVES}
    n = {c: 0 for c in COLLECTIVES}
    f = {c: 0 for c in COLLECTIVES}
    for kind, shape, dtype in records:
        numel = 1
        for d in shape:
            numel *= d
        nbytes = numel * dtype.itemsize
        b[kind] += nbytes
        n[kind] += 1
        if dtype == torch.float32:
            f[kind] += nbytes
    return {"bytes": b, "counts": n, "bytes_f32": f, "scaled": True}


def link_bytes(totals: dict) -> float:
    return sum(LINK_FACTOR[c] * totals["bytes"][c] for c in COLLECTIVES)
