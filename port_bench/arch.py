"""What the harness asks about an architecture, answered in one place.

A configuration's reference module, ``reference/<name>.py`` (named by its
``reference`` key), may define these hooks; where it does not, the
decoder-only llama tree's default applies:

- ``ARCH_KEYS``: {key: default} of the further keys the architecture reads,
  published ones (at the file's top level, under the source's names) and
  ``run`` ones; :func:`port_bench.model.load` puts them in ``Model.arch``,
  and the ``run`` ones go to the port's ``ModelConfig`` by name; default
  none;
- ``leaf_specs(m)``: the parameter tree as [(path, shape, fan_in)], an
  empty node (a norm without parameters) as (path, None, 0); default
  :func:`port_bench.weights.leaf_specs`;
- ``forward_flops(m, b, s)``: model FLOPs of one forward at b x s tokens;
  default :func:`port_bench.flops.forward_flops`;
- ``attention_layers(m, b, s)``: one ((fwd FLOPs, fwd bytes), (bwd FLOPs,
  bwd bytes)) for each attention layer of a forward; default
  :func:`port_bench.flops.attention_layers`, every one of ``n_layers``
  causal and full-width;
- ``moe_layers(m)``: the MoE layer's calls in a forward; default
  ``n_layers`` with experts, else 0.

The weights, the FLOP arithmetic, the drivers and the metric readers ask
here, and nowhere else.
"""
from __future__ import annotations

from . import spec

__all__ = ["HOOKS", "keys", "hook", "leaf_specs", "forward_flops",
           "attention_layers", "moe_layers"]


def _moe_layers(m) -> int:
    return m.n_layers if m.is_moe else 0


def _defaults() -> dict:
    # imported here: weights and flops ask this module in turn
    from . import flops, weights
    return {"leaf_specs": weights.leaf_specs,
            "forward_flops": flops.forward_flops,
            "attention_layers": flops.attention_layers,
            "moe_layers": _moe_layers}


#: the hooks a reference module may define beside ``ARCH_KEYS``
HOOKS = ("leaf_specs", "forward_flops", "attention_layers", "moe_layers")


def keys(reference: str) -> dict:
    """``ARCH_KEYS`` of reference module ``reference``, else {}."""
    return dict(getattr(spec.module("reference", reference), "ARCH_KEYS",
                        {}))


def hook(reference: str, name: str):
    """Hook ``name`` (one of :data:`HOOKS`) of reference module
    ``reference``, or its default."""
    got = getattr(spec.module("reference", reference), name, None)
    return got if got is not None else _defaults()[name]


def leaf_specs(m) -> list:
    return hook(m.reference, "leaf_specs")(m)


def forward_flops(m, b: int, s: int) -> int:
    return hook(m.reference, "forward_flops")(m, b, s)


def attention_layers(m, b: int, s: int) -> list:
    return hook(m.reference, "attention_layers")(m, b, s)


def moe_layers(m) -> int:
    return hook(m.reference, "moe_layers")(m)
