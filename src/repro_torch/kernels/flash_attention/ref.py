"""Plain PyTorch version of the flash-attention kernel.

Mirrors ``repro.kernels.flash_attention.ref``: GQA scaled-dot-product
attention in fp32, output in q's dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention"]


def attention(q, k, v, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D) with H % KV == 0.
    ``window > 0`` (with ``causal``) also masks keys with ``q - k >= window``,
    the local attention of ``repro.models.layers.attention_forward``."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, d).to(torch.float32)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    scores = scores / math.sqrt(d)
    if causal:
        diff = (torch.arange(sq, device=q.device)[:, None]
                - torch.arange(sk, device=q.device)[None, :])
        mask = diff >= 0
        if window:
            mask &= diff < window
        scores = scores.masked_fill(~mask[None, None, None], -math.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)
