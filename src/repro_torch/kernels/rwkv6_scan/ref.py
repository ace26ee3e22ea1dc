"""Plain PyTorch version of the WKV6 kernel.

Mirrors ``repro.kernels.rwkv6_scan.ref``: the sequential per-token
recurrence in fp32,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``wkv6_chunked`` does the CUDA kernel's arithmetic: chunk summaries (each
chunk's decay and state contribution), the states entering the chunks
folded in chunk order, then each chunk's outputs from its entering state,
its strictly-lower-triangular intra-chunk matrix and the bonus diagonal.

Both compute in fp32 for fp32 or bf16 inputs, as the kernel does, and in
fp64 for fp64 inputs: an oracle whose own rounding is negligible next to
the kernel's limit.  With decays near 1 over thousands of tokens the
sequential fp32 form is not: every step multiplies by the same rounded w,
so its error grows with T.
"""
from __future__ import annotations

import torch

__all__ = ["wkv6", "wkv6_chunked"]


def _compute_dtype(r):
    return torch.promote_types(r.dtype, torch.float32)


def wkv6(r, k, v, log_w, u, S0=None):
    """r, k, v, log_w: (B, H, T, N); u: (H, N); S0: (B, H, N, N) or None.
    Returns (o (B, H, T, N) in r's dtype, S_final (B, H, N, N) fp32, or
    fp64 for fp64 inputs)."""
    dtype = _compute_dtype(r)
    b, h, t, n = r.shape
    r32, k32, v32 = (x.to(dtype) for x in (r, k, v))
    w = torch.exp(log_w.to(dtype))
    u32 = u.to(dtype)[None, :, :, None]
    S = (torch.zeros((b, h, n, v.shape[-1]), dtype=dtype, device=r.device)
         if S0 is None else S0.to(dtype))
    outs = []
    for i in range(t):
        kv = k32[:, :, i, :, None] * v32[:, :, i, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", r32[:, :, i],
                                 S + u32 * kv))
        S = w[:, :, i, :, None] * S + kv
    o = (torch.stack(outs, 2) if outs
         else v32.new_zeros((b, h, 0, v.shape[-1])))
    return o.to(r.dtype), S


def wkv6_chunked(r, k, v, log_w, u, S0=None, chunk: int = 16):
    """The same recurrence as the kernel computes it, in chunks of
    ``chunk`` tokens, with cum the in-chunk inclusive cumsum of log_w:
    1. each chunk's decay d_c = exp(cum_L) and contribution
       U_c = (k_j exp(cum_L - cum_j))^T v;
    2. the state entering chunk c folded from S0 (or 0) as
       S_{c+1} = diag(d_c) S_c + U_c in chunk order;
    3. o = (r P_{t-1}) S_c + tril_{-1}(A) v + (r_t . (u k_t)) v_t with
       P = exp(cum) and A[t, j] = (r_t P_{t-1}) . (k_j / P_j).
    The ragged last chunk is padded with k = 0 and log_w = 0, which leave
    the state unchanged.  Exact in fp32 only for log_w in the model's clamp
    [-2.5, -1e-4] at ``chunk`` = 16 (exp(+-cum) stays in range).  Same
    arguments and results as :func:`wkv6`."""
    dtype = _compute_dtype(r)
    b, h, t, n = r.shape
    nc = -(-t // chunk)

    def tiles(x):
        x = torch.nn.functional.pad(x.to(dtype), (0, 0, 0, nc * chunk - t))
        return x.reshape(b, h, nc, chunk, n)

    r32, k32, v32, lw = (tiles(x) for x in (r, k, v, log_w))
    cum = torch.cumsum(lw, 3)
    prev = torch.nn.functional.pad(cum[:, :, :, :-1], (0, 0, 1, 0))
    total = cum[:, :, :, -1:]
    # 1. chunk summaries
    dec = torch.exp(total[:, :, :, 0])                       # (B, H, C, N)
    U = torch.einsum("bhcjn,bhcjm->bhcnm", k32 * torch.exp(total - cum),
                     v32)
    # 2. the fold over chunks
    S = (torch.zeros((b, h, n, n), dtype=dtype, device=r.device)
         if S0 is None else S0.to(dtype))
    entering = []
    for c in range(nc):
        entering.append(S)
        S = dec[:, :, c, :, None] * S + U[:, :, c]
    if not nc:
        return v32.new_zeros((b, h, 0, n)).to(r.dtype), S
    Sc = torch.stack(entering, 2)                            # (B,H,C,N,N)
    # 3. outputs
    q = r32 * torch.exp(prev)
    A = torch.einsum("bhctn,bhcjn->bhctj", q, k32 * torch.exp(-cum))
    A = torch.tril(A, -1) + torch.diag_embed(
        (r32 * u.to(dtype)[None, :, None, None, :] * k32).sum(-1))
    o = (torch.einsum("bhctn,bhcnm->bhctm", q, Sc)
         + torch.einsum("bhctj,bhcjm->bhctm", A, v32))
    return o.reshape(b, h, nc * chunk, n)[:, :, :t].to(r.dtype), S
