"""The benchmark's reading of a configuration file.

A configuration file (``configs/<name>.json``) holds the published keys of
its source, under the source's names, and a ``run`` group with what the
port needs beyond them (norm, block wiring, dtypes, MoE dispatch).  This
module turns it into :class:`Model`, which the weights, the FLOP
arithmetic, the reference and the drivers read.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Model", "load"]

#: published key -> Model field (a key absent from the file keeps the
#: field's default)
SOURCE_KEYS = {
    "hidden_size": "d_model",
    "intermediate_size": "d_ff",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "vocab_size": "vocab_size",
    "tie_word_embeddings": "tie_embeddings",
    "rope_theta": "rope_theta",
    "attention_bias": "use_bias",
    "num_local_experts": "n_experts",
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

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def load(name: str, data: dict, **overrides) -> Model:
    """:class:`Model` of configuration file ``data`` (``overrides`` replace
    fields, for the CPU tests' small sizes)."""
    kw = {field: data[key] for key, field in SOURCE_KEYS.items()
          if key in data}
    kw.update(data.get("run", {}))
    kw.update(overrides)
    return Model(name=name, **kw)
