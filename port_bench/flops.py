"""Model FLOPs of a train step and the work of the attention kernels.

Copied, frozen, from the program's measurement code at commit 93b320d:
``matmul_params``, ``mixing_flops``, ``forward_flops`` and ``train_flops``
from ``chip_smoke.py`` (decoder-only branches), and ``attended_pairs`` with
the flash-attention wrappers' counts (``_report_fwd``, ``_report_bwd`` in
``src/repro_torch/kernels/flash_attention/ops.py``): each input read once,
each output written once, the operations these inputs need.  They read the
benchmark's :class:`~port_bench.model.Model`, not the program's config,
and are the defaults of an architecture whose reference module defines no
``forward_flops`` or ``attention_layers`` hook (:mod:`port_bench.arch`).
"""
from __future__ import annotations

from . import arch
from .model import Model

__all__ = ["attended_pairs", "matmul_params", "forward_flops",
           "train_model_flops", "attention_fwd_work", "attention_bwd_work",
           "attention_layers"]


def attended_pairs(s: int, causal: bool, window: int = 0,
                   sk: int | None = None) -> int:
    """(query, key) pairs a head attends at s queries (and sk keys)."""
    if not causal:
        return s * (s if sk is None else sk)
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def matmul_params(m: Model) -> int:
    """Parameters that enter a matrix product a token: the attention
    projections, the MLP or the router and ``top_k`` experts, the head (the
    embedding is a gather)."""
    d, ff = m.d_model, m.d_ff
    mlp = (d * m.n_experts + m.top_k * 3 * d * ff if m.is_moe
           else 3 * d * ff)
    attn = 2 * d * m.n_heads * m.head_dim + 2 * d * m.n_kv_heads * m.head_dim
    return m.n_layers * (attn + mlp) + d * m.vocab_size


def forward_flops(m: Model, b: int, s: int) -> int:
    """FLOPs of one forward at b x s tokens: 2 x the matmul parameters each
    token passes, plus causal attention's two products."""
    mixing = m.n_layers * 4 * b * m.n_heads * attended_pairs(s, True) \
        * m.head_dim
    return 2 * b * s * matmul_params(m) + mixing


def train_model_flops(m: Model, b: int, s: int) -> int:
    """Model FLOPs of a train step: three forwards (the forward, and a
    backward of twice its products); what remat recomputes is not counted.
    A forward is the architecture's (:func:`port_bench.arch.forward_flops`)."""
    return 3 * arch.forward_flops(m, b, s)


def attention_fwd_work(m: Model, b: int, s: int, dtype_bytes: int = 2,
                       with_lse: bool = True) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal forward launch over a layer: QK^T and
    PV; q, k, v read and o written once (and the row log-sum-exp that
    training keeps)."""
    h, kv, d = m.n_heads, m.n_kv_heads, m.head_dim
    pairs = attended_pairs(s, True)
    nbytes = dtype_bytes * (2 * b * h * s * d + 2 * b * kv * s * d)
    return 4 * b * h * pairs * d, nbytes + (4 * b * h * s if with_lse else 0)


def attention_bwd_work(m: Model, b: int, s: int,
                       dtype_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal backward call over a layer: S, dP, dV,
    dK, dQ; q, o, dO read and dq written (B, H, S, D), k, v read and dk, dv
    written (B, KV, S, D), the log-sum-exp read."""
    h, kv, d = m.n_heads, m.n_kv_heads, m.head_dim
    pairs = attended_pairs(s, True)
    nbytes = dtype_bytes * (4 * b * h * s * d + 4 * b * kv * s * d) \
        + 4 * b * h * s
    return 10 * b * h * pairs * d, nbytes


def attention_layers(m: Model, b: int, s: int) -> list:
    """((fwd FLOPs, fwd bytes), (bwd FLOPs, bwd bytes)) of each attention
    layer of a forward at b x s tokens, every one of ``n_layers`` causal and
    full-width."""
    return [(attention_fwd_work(m, b, s), attention_bwd_work(m, b, s))] \
        * m.n_layers
