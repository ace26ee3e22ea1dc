"""Plain PyTorch versions of the flash-attention kernels.

Mirrors ``repro.kernels.flash_attention.ref``: GQA scaled-dot-product
attention in fp32, output in q's dtype.  :func:`attention_lse` is the
forward's row log-sum-exp and :func:`attention_backward` the backward's
arithmetic (``csrc/flash_attention_bwd.cu``): P recomputed from the lse,
``delta = rowsum(dO * O)``, ``dS = P * (dP - delta)``.
:func:`attention_backward_rounded` adds the bf16 tensor-core kernel's
roundings of P and dS.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention", "attention_lse", "attention_backward",
           "attention_backward_rounded"]


def _scores(q, k, causal: bool, window: int):
    """fp32 scaled scores (B, KV, G, Sq, Sk), masked entries -inf."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).to(torch.float32)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    scores = scores / math.sqrt(d)
    if causal:
        diff = (torch.arange(sq, device=q.device)[:, None]
                - torch.arange(sk, device=q.device)[None, :])
        mask = diff >= 0
        if window:
            mask &= diff < window
        scores = scores.masked_fill(~mask[None, None, None], -math.inf)
    return scores


def attention(q, k, v, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D) with H % KV == 0.
    ``window > 0`` (with ``causal``) also masks keys with ``q - k >= window``,
    the local attention of ``repro.models.layers.attention_forward``."""
    b, h, sq, d = q.shape
    w = torch.softmax(_scores(q, k, causal, window), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_lse(q, k, v, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """The natural-log log-sum-exp of each query row's scaled scores,
    (B, H, Sq) fp32: what the forward kernel writes for the backward."""
    b, h, sq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1)
    return lse.reshape(b, h, sq)


def attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                       window: int = 0):
    """(dq, dk, dv) of :func:`attention` at output gradient ``do``, from
    the forward's output ``o`` and row log-sum-exp ``lse``, in fp32 and
    returned in the inputs' dtypes: P = exp(S - lse) (masked entries exactly
    0), dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = P (dP -
    delta), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D); GQA sums dK and dV
    over the query heads of a group."""
    return _backward(q, k, v, o, lse, do, causal, window, None)


def attention_backward_rounded(q, k, v, o, lse, do, *, causal: bool = True,
                               window: int = 0):
    """:func:`attention_backward` as the bf16 tensor-core kernel computes
    it: P and dS rounded to bf16 before the products that take them (dV =
    P^T dO, dQ = dS K, dK = dS^T Q), every sum in fp32, each gradient
    rounded to the inputs' dtype once (bf16 on the kernel's path)."""
    return _backward(q, k, v, o, lse, do, causal, window, torch.bfloat16)


def _backward(q, k, v, o, lse, do, causal, window, operand_dtype):
    """The backward in fp32; ``operand_dtype`` (or None) is the type P and
    dS are rounded to before their products."""
    def operand(x):
        return x if operand_dtype is None else \
            x.to(operand_dtype).to(torch.float32)

    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = 1.0 / math.sqrt(d)

    def grouped(x):
        return x.reshape(b, kv, g, sq, d).to(torch.float32)

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    p = torch.exp(_scores(q, k, causal, window)
                  - lse.reshape(b, kv, g, sq, 1).to(torch.float32))
    dv = torch.einsum("bkgqs,bkgqd->bksd", operand(p), dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = operand(p * (dp - delta))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
