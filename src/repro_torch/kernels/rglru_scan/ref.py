"""Plain PyTorch version of the RG-LRU scan kernel.

Mirrors ``repro.kernels.rglru_scan.ref``: ``h_t = a_t h_{t-1} + b_t`` in
fp32, with an optional entering state folded into the first step, computed
as JAX's ``associative_scan`` does, by recursive doubling over time.
"""
from __future__ import annotations

import torch

__all__ = ["lru_scan"]


def lru_scan(a, b, h0=None):
    """a, b: (B, S, W); h0: (B, W) or None.  Returns (h (B, S, W) fp32,
    h_last (B, W) fp32)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(torch.float32)
    # after the pass at distance d, (a[t], b[t]) compose steps (t-2d, t]
    d = 1
    while d < a.shape[1]:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1))
        d *= 2
    return b, b[:, -1]
