"""Plain PyTorch versions of the RG-LRU scan kernel.

``lru_scan`` mirrors ``repro.kernels.rglru_scan.ref``: ``h_t = a_t h_{t-1}
+ b_t`` in fp32, with an optional entering state folded into the first
step, computed as JAX's ``associative_scan`` does, by recursive doubling
over time.  ``lru_scan_chunked`` does the CUDA kernel's arithmetic: chunk
summaries, carry-ins folded in chunk order, each chunk re-run from its
carry-in.  ``lru_scan_backward`` is the recurrence's gradient, the same
recurrence run backward in time with ``a`` shifted by one step, as the
backward kernel computes it.
"""
from __future__ import annotations

import torch

__all__ = ["lru_scan", "lru_scan_chunked", "lru_scan_backward"]


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


def lru_scan_backward(a, h, dh, dh_last=None, h0=None):
    """Gradient of :func:`lru_scan` at output gradients ``dh`` (B, S, W) and
    ``dh_last`` (B, W) (None: zero), from ``a`` and the forward's ``h``:

        g_S = dh_S + dh_last,   g_t = dh_t + a_{t+1} g_{t+1}
        db_t = g_t,   da_t = g_t h_{t-1} (h_0 = h0, or 0),   dh0 = a_1 g_1

    all in fp32.  The reverse recurrence is :func:`lru_scan` on reversed
    time (its entering state ``dh_last``).  Returns (da, db, dh0) fp32,
    ``dh0`` None when ``h0`` is None."""
    a = a.to(torch.float32)
    h = h.to(torch.float32)
    dh = dh.to(torch.float32)
    # reversed time: the step of t multiplies the carry by a_{t+1} (by 1 at
    # t = S - 1, where the carry is dh_last)
    a_rev = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1).flip(1)
    g, _ = lru_scan(a_rev, dh.flip(1), dh_last)
    g = g.flip(1)
    prev = torch.zeros_like(h[:, :1]) if h0 is None else \
        h0.to(torch.float32)[:, None]
    da = g * torch.cat([prev, h[:, :-1]], 1)
    dh0 = None if h0 is None else a[:, 0] * g[:, 0]
    return da, g, dh0
