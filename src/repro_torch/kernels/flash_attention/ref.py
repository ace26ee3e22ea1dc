"""Plain PyTorch versions of the flash-attention kernels.

Mirrors ``repro.kernels.flash_attention.ref``: GQA scaled-dot-product
attention in fp32, output in q's dtype.  :func:`attention_lse` is the
forward's row log-sum-exp and :func:`attention_backward` the backward's
arithmetic (``csrc/flash_attention_bwd.cu``): P recomputed from the lse,
``delta = rowsum(dO * O)``, ``dS = P * (dP - delta)``.
:func:`attention_backward_rounded` adds the bf16 tensor-core kernel's
roundings of P and dS.  :func:`attention_split_tf32` and
:func:`attention_backward_split_tf32` are the fp32 kernels' arithmetic:
every product a split TF32 product (:func:`split_tf32_einsum`).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention", "attention_lse", "attention_backward",
           "attention_backward_rounded", "tf32_round", "tf32_truncate",
           "split_tf32_einsum",
           "attention_split_tf32", "attention_backward_split_tf32"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does on the H100, by bit masks: the
    low 13 bits cleared after adding half of their span to the magnitude (a
    carry into the exponent is the rounding up it should be, up to inf past
    the largest value); subnormals round on the same grid; inf stays.  A
    NaN has its low 13 bits cleared without rounding, as the card does (one
    whose payload lies only there becomes inf)."""
    bits = x.to(torch.float32).view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    cut = (bits & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), cut, out)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as the tensor cores read a TF32 operand: its low 13 bits
    dropped (a truncation toward zero)."""
    bits = x.to(torch.float32).view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                      terms: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the fp32 kernels take a product on the
    tensor cores: each operand split into ``hi = tf32(x)``
    (:func:`tf32_round`) and ``lo = x - hi`` (exact), which the tensor
    cores read truncated (:func:`tf32_truncate`), and ``a_hi b_hi + (a_hi
    b_lo + a_lo b_hi)`` summed in fp32 (the ``lo lo`` term dropped).
    ``terms=1`` is one TF32 pass, ``a_hi b_hi`` alone."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if terms == 1:
        return out
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return out + (torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi))


def _scores(q, k, causal: bool, window: int, product=torch.einsum):
    """fp32 scaled scores (B, KV, G, Sq, Sk), masked entries -inf."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).to(torch.float32)
    scores = product("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
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


def attention_split_tf32(q, k, v, *, causal: bool = True, window: int = 0,
                         terms: int = 3) -> torch.Tensor:
    """:func:`attention` in fp32 as the fp32 kernel computes it: S = Q K^T
    and P V split TF32 products (:func:`split_tf32_einsum`), P = exp(S -
    max) unnormalised into the product and divided by its row sum after,
    every sum fp32.  ``terms=1``: one TF32 pass a product instead."""
    b, h, sq, d = q.shape
    kv = k.shape[1]

    def product(eq, x, y):
        return split_tf32_einsum(eq, x, y, terms)

    scores = _scores(q, k, causal, window, product)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    out = product("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    out = out / l.clamp_min(1e-30)
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


def attention_backward_split_tf32(q, k, v, o, lse, do, *, causal: bool = True,
                                  window: int = 0, terms: int = 3):
    """:func:`attention_backward` as the fp32 kernels compute it: every
    product (S, dP, dV, dQ, dK) a split TF32 product
    (:func:`split_tf32_einsum`) with P and dS split like any operand, delta
    and every sum fp32.  ``terms=1``: one TF32 pass a product instead."""
    def product(eq, x, y):
        return split_tf32_einsum(eq, x, y, terms)

    return _backward(q, k, v, o, lse, do, causal, window, None, product)


def _backward(q, k, v, o, lse, do, causal, window, operand_dtype,
              product=torch.einsum):
    """The backward in fp32; ``operand_dtype`` (or None) is the type P and
    dS are rounded to before their products, ``product`` the einsum that
    takes each product."""
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
    p = torch.exp(_scores(q, k, causal, window, product)
                  - lse.reshape(b, kv, g, sq, 1).to(torch.float32))
    dv = product("bkgqs,bkgqd->bksd", operand(p), dog)
    dp = product("bkgqd,bksd->bkgqs", dog, vf)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = operand(p * (dp - delta))
    dq = product("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = product("bkgqs,bkgqd->bksd", ds, qg) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
