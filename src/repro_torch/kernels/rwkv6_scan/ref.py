"""Plain PyTorch version of the WKV6 kernel.

Mirrors ``repro.kernels.rwkv6_scan.ref``: the sequential per-token
recurrence in fp32,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
"""
from __future__ import annotations

import torch

__all__ = ["wkv6"]


def wkv6(r, k, v, log_w, u, S0=None):
    """r, k, v, log_w: (B, H, T, N); u: (H, N); S0: (B, H, N, N) or None.
    Returns (o (B, H, T, N) in r's dtype, S_final (B, H, N, N) fp32)."""
    b, h, t, n = r.shape
    r32, k32, v32 = (x.to(torch.float32) for x in (r, k, v))
    w = torch.exp(log_w.to(torch.float32))
    u32 = u.to(torch.float32)[None, :, :, None]
    S = (torch.zeros((b, h, n, v.shape[-1]), dtype=torch.float32,
                     device=r.device)
         if S0 is None else S0.to(torch.float32))
    outs = []
    for i in range(t):
        kv = k32[:, :, i, :, None] * v32[:, :, i, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", r32[:, :, i],
                                 S + u32 * kv))
        S = w[:, :, i, :, None] * S + kv
    o = (torch.stack(outs, 2) if outs
         else v32.new_zeros((b, h, 0, v.shape[-1])))
    return o.to(r.dtype), S
