"""The benchmark's reading of a configuration file.

A configuration file (``configs/<name>.json``) holds the published keys of
its source, under the source's names, and a ``run`` group with what the
port needs beyond them (norm, block wiring, dtypes, MoE dispatch).  This
module turns it into :class:`Model`, which the weights, the FLOP
arithmetic, the reference and the drivers read.  The keys an architecture
reads beyond :class:`Model`'s fields are named by its reference module's
``ARCH_KEYS`` (:mod:`port_bench.arch`) and kept in ``Model.arch``.
"""
from __future__ import annotations

import dataclasses

from . import arch as _arch

__all__ = ["Model", "load"]

#: published key -> Model field (a key absent from the file keeps the
#: field's default)
SOURCE_KEYS = {
    "hidden_size": "d_model",
    "intermediate_size": "d_ff",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim",
    "vocab_size": "vocab_size",
    "tie_word_embeddings": "tie_embeddings",
    "rope_theta": "rope_theta",
    "attention_bias": "use_bias",
    "num_local_experts": "n_experts",
    "num_experts": "n_experts",
    "num_experts_per_tok": "top_k",
}


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    d_model: int
    d_ff: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    head_dim: int = 0                 # 0: d_model // n_heads
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    use_bias: bool = False
    n_experts: int = 0
    top_k: int = 0
    # the ``run`` group
    family: str = "dense"
    block_type: str = "llama"
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"
    capacity_factor: float = 1.25
    moe_group: int = 2048
    aux_coef: float = 0.01
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    reference: str = "decoder"
    #: the reference module's ``ARCH_KEYS``, read from the file
    arch: dict = dataclasses.field(default_factory=dict)
    #: the keys of ``arch`` that the ``run`` group gives: the port's
    #: ``ModelConfig`` takes them by name
    passed: tuple = ()

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


#: the fields a configuration file may set
_FIELDS = frozenset(f.name for f in dataclasses.fields(Model)) - {
    "name", "arch", "passed"}


def load(name: str, data: dict, **overrides) -> Model:
    """:class:`Model` of configuration file ``data`` (``overrides`` replace
    fields or ``arch`` keys, for the CPU tests' small sizes).  Raises a
    ``ValueError`` naming any ``run`` key that neither :class:`Model` nor the
    reference module's ``ARCH_KEYS`` knows."""
    run = data.get("run", {})
    reference = overrides.get("reference", run.get("reference", "decoder"))
    keys = _arch.keys(reference)
    unknown = sorted(set(run) - _FIELDS - set(keys))
    if unknown:
        raise ValueError(f"configuration {name!r}: run keys "
                         f"{', '.join(unknown)} are neither Model fields "
                         f"nor in reference/{reference}.py's ARCH_KEYS")
    kw = {field: data[key] for key, field in SOURCE_KEYS.items()
          if key in data}
    kw.update((k, v) for k, v in run.items() if k in _FIELDS)
    arch = {k: data.get(k, run.get(k, default)) for k, default in keys.items()}
    arch.update((k, v) for k, v in overrides.items() if k in keys)
    kw.update((k, v) for k, v in overrides.items() if k not in keys)
    return Model(name=name, arch=arch,
                 passed=tuple(k for k in keys if k in run and k not in data),
                 **kw)

