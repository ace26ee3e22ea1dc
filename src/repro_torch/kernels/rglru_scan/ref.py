"""Plain PyTorch versions of the RG-LRU scan kernel.

``lru_scan`` mirrors ``repro.kernels.rglru_scan.ref``: ``h_t = a_t h_{t-1}
+ b_t`` in fp32, with an optional entering state folded into the first
step, computed as JAX's ``associative_scan`` does, by recursive doubling
over time.  ``lru_scan_chunked`` does the CUDA kernel's arithmetic: chunk
summaries, carry-ins folded in chunk order, each chunk re-run from its
carry-in.
"""
from __future__ import annotations

import torch

__all__ = ["lru_scan", "lru_scan_chunked"]


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


def lru_scan_chunked(a, b, h0=None, chunk: int = 128):
    """The same recurrence as the kernel computes it, in chunks of
    ``chunk`` steps: each chunk's affine summary (prod a, its scan from 0),
    the carry-in of chunk c folded from ``h0`` (or 0) through the summaries
    of chunks 0..c-1 in order, then each chunk scanned from its carry-in.
    a, b: (B, S, W) with S >= 1; h0: (B, W) or None.  Returns (h (B, S, W)
    fp32, h_last (B, W) fp32)."""
    bsz, s, w = a.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    # a = 1, b = 0 past the end leave every summary and state unchanged
    a = torch.nn.functional.pad(a.to(torch.float32), (0, 0, 0, pad),
                                value=1.0).reshape(bsz, n, chunk, w)
    b = torch.nn.functional.pad(b.to(torch.float32),
                                (0, 0, 0, pad)).reshape(bsz, n, chunk, w)
    prod = torch.ones((bsz, n, w), dtype=torch.float32, device=a.device)
    hc = torch.zeros((bsz, n, w), dtype=torch.float32, device=a.device)
    for t in range(chunk):
        prod = prod * a[:, :, t]
        hc = a[:, :, t] * hc + b[:, :, t]
    carry = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
             if h0 is None else h0.to(torch.float32))
    carries = []
    for c in range(n):
        carries.append(carry)
        carry = prod[:, c] * carry + hc[:, c]
    hv = torch.stack(carries, 1)
    h = torch.empty_like(a)
    for t in range(chunk):
        hv = a[:, :, t] * hv + b[:, :, t]
        h[:, :, t] = hv
    h = h.reshape(bsz, n * chunk, w)[:, :s]
    return h, h[:, -1]
