"""Plain PyTorch version of the WKV6 kernel.

Mirrors ``repro.kernels.rwkv6_scan.ref``: the sequential per-token
recurrence in fp32,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``wkv6_chunked`` does the CUDA kernel's arithmetic: chunk summaries (each
chunk's decay and state contribution), the states entering the chunks
folded in chunk order, then each chunk's outputs from its entering state,
its strictly-lower-triangular intra-chunk matrix and the bonus diagonal.

``wkv6_backward`` is the recurrence's gradient in the sequential form and
``wkv6_backward_chunked`` the backward kernel's arithmetic (the chunks'
``sum_t (r_t P_{t-1})^T do_t``, a reverse fold of the state's gradient over
chunks, then each chunk's gradients from its entering state and its
leaving gradient; the decay's gradient as a reverse cumulative sum).

All compute in fp32 for fp32 or bf16 inputs, as the kernels do, and in
fp64 for fp64 inputs: an oracle whose own rounding is negligible next to
the kernel's limit.  With decays near 1 over thousands of tokens the
sequential fp32 form is not: every step multiplies by the same rounded w,
so its error grows with T.
"""
from __future__ import annotations

import torch

__all__ = ["wkv6", "wkv6_chunked", "wkv6_backward", "wkv6_backward_chunked"]


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


def wkv6_backward(r, k, v, log_w, u, do, S0=None, dS=None):
    """Gradient of :func:`wkv6` at output gradient ``do`` (B, H, T, N) and
    final-state gradient ``dS`` ((B, H, N, N) or None: zero), sequentially,
    with G_t the gradient of S_t (G_T = dS):

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) do_t
        dk_t = u r_t (v_t . do_t) + G_t v_t
        dv_t = (r_t . (u k_t)) do_t + G_t^T k_t
        dlog_w_t = w_t rowsum(G_t * S_{t-1})
        G_{t-1} = r_t^T do_t + diag(w_t) G_t
        du = sum_{b, t} r_t k_t (v_t . do_t),   dS0 = G_0

    The forward's states are recomputed and kept, (B, H, T, N, N).  Returns
    (dr, dk, dv in r's dtype, dlog_w (B, H, T, N), du (H, N), dS0 (B, H, N,
    N) or None), fp32 (fp64 for fp64 inputs)."""
    dtype = _compute_dtype(r)
    b, h, t, n = r.shape
    r32, k32, v32, do32 = (x.to(dtype) for x in (r, k, v, do))
    w = torch.exp(log_w.to(dtype))
    u32 = u.to(dtype)[None, :, :, None]
    S = (torch.zeros((b, h, n, n), dtype=dtype, device=r.device)
         if S0 is None else S0.to(dtype))
    states = []                                  # S_{t-1} of each step
    for i in range(t):
        states.append(S)
        S = w[:, :, i, :, None] * S + k32[:, :, i, :, None] * \
            v32[:, :, i, None, :]
    G = (torch.zeros((b, h, n, n), dtype=dtype, device=r.device)
         if dS is None else dS.to(dtype))
    dr, dk, dv, dlw = (torch.zeros_like(r32) for _ in range(4))
    du = torch.zeros((h, n), dtype=dtype, device=r.device)
    for i in reversed(range(t)):
        rt, kt, vt, dot = (x[:, :, i] for x in (r32, k32, v32, do32))
        vdo = (vt * dot).sum(-1, keepdim=True)              # (B, H, 1)
        kv = kt[..., :, None] * vt[..., None, :]
        dr[:, :, i] = torch.einsum("bhnm,bhm->bhn", states[i] + u32 * kv,
                                   dot)
        dk[:, :, i] = u.to(dtype) * rt * vdo + torch.einsum(
            "bhnm,bhm->bhn", G, vt)
        dv[:, :, i] = (rt * u.to(dtype) * kt).sum(-1, keepdim=True) * dot \
            + torch.einsum("bhnm,bhn->bhm", G, kt)
        dlw[:, :, i] = w[:, :, i] * (G * states[i]).sum(-1)
        du = du + (rt * kt * vdo).sum(0)
        G = rt[..., :, None] * dot[..., None, :] + w[:, :, i, :, None] * G
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw, du,
            None if S0 is None else G)


def wkv6_backward_chunked(r, k, v, log_w, u, do, S0=None, dS=None,
                          chunk: int = 16):
    """:func:`wkv6_backward` as the backward kernel computes it, in chunks
    of ``chunk`` tokens with cum the in-chunk inclusive cumsum of log_w,
    P = exp(cum), q_t = r_t P_{t-1}, kd_t = k_t exp(cum_L - cum_t), S_c the
    state entering chunk c (the forward's fold) and B[i, j] = do_i . v_j:
    1. each chunk's V_c = q^T do;
    2. the gradient G^c of the state leaving chunk c, folded in reverse
       chunk order from dS (or 0): G^{c-1} = diag(d_c) G^c + V_c, and
       dS0 = G^{-1};
    3. each chunk's gradients:
       dr = P_{i-1} (S_c do_i + sum_{j<i} B[i, j] k_j / P_j) + u k_i B[i, i],
       dk = u r_i B[i, i] + exp(cum_L - cum_i) G^c v_i
            + exp(-cum_i) sum_{j>i} B[j, i] q_j,
       dv = sum_{j>=i} A[j, i] do_j + kd_i G^c (A the forward's intra-chunk
       matrix, its bonus on the diagonal);
    4. the decay's gradient, dlog_w_s = sum_{t>s} r_t dr'_t -
       sum_{t>=s} k_t dk'_t + rowsum(dS * S_T) (dr', dk' without the bonus
       terms: the gradient of each in-chunk log-decay sum, gathered), as
       each chunk's reverse sums over its own tokens plus its carry,
       rowsum(G^c * S_{c+1}): the gradient of a log-decay shift between
       chunks c and c+1, every (j, t) pair that crosses it, with
       S_{c+1} = diag(d_c) S_c + kd^T v, so rowsum(G^c * S_{c+1}) =
       d_c rowsum(G^c * S_c) + sum_i kd_i (G^c v_i).
    Same arguments and results as :func:`wkv6_backward`."""
    dtype = _compute_dtype(r)
    b, h, t, n = r.shape
    nc = -(-t // chunk)
    L = chunk

    def tiles(x):
        x = torch.nn.functional.pad(x.to(dtype), (0, 0, 0, nc * L - t))
        return x.reshape(b, h, nc, L, n)

    r32, k32, v32, lw, do32 = (tiles(x) for x in (r, k, v, log_w, do))
    u32 = u.to(dtype)[None, :, None, None, :]
    cum = torch.cumsum(lw, 3)
    prev = torch.nn.functional.pad(cum[:, :, :, :-1], (0, 0, 1, 0))
    total = cum[:, :, :, -1:]
    q = r32 * torch.exp(prev)
    kp = k32 * torch.exp(-cum)
    kd = k32 * torch.exp(total - cum)
    # the forward's fold: the state entering each chunk
    dec = torch.exp(total[:, :, :, 0])                       # (B, H, C, N)
    U = torch.einsum("bhcjn,bhcjm->bhcnm", kd, v32)
    S = (torch.zeros((b, h, n, n), dtype=dtype, device=r.device)
         if S0 is None else S0.to(dtype))
    entering = []
    for c in range(nc):
        entering.append(S)
        S = dec[:, :, c, :, None] * S + U[:, :, c]
    # 1. V_c, 2. the reverse fold
    V = torch.einsum("bhcin,bhcim->bhcnm", q, do32)
    G = (torch.zeros((b, h, n, n), dtype=dtype, device=r.device)
         if dS is None else dS.to(dtype))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = G
        G = dec[:, :, c, :, None] * G + V[:, :, c]
    if not nc:
        z = r32.new_zeros((b, h, 0, n))
        return (z.to(r.dtype), z.to(k.dtype), z.to(v.dtype), z,
                torch.zeros((h, n), dtype=dtype, device=r.device),
                None if S0 is None else G)
    Sc = torch.stack(entering, 2)                            # (B,H,C,N,N)
    Gc = torch.stack(leaving, 2)
    # 3. each chunk's gradients
    Bm = torch.einsum("bhcin,bhcjn->bhcij", do32, v32)
    diag = torch.diagonal(Bm, dim1=-2, dim2=-1)[..., None]   # (B,H,C,L,1)
    lower = torch.tril(Bm, -1)                               # j < i
    A = torch.tril(torch.einsum("bhctn,bhcjn->bhctj", q, kp), -1) \
        + torch.diag_embed((r32 * u32 * k32).sum(-1))
    dr_nb = torch.exp(prev) * (torch.einsum("bhcnm,bhcim->bhcin", Sc, do32)
                               + torch.einsum("bhcij,bhcjn->bhcin", lower,
                                              kp))
    dk_nb = torch.exp(total - cum) * torch.einsum("bhcnm,bhcim->bhcin", Gc,
                                                  v32) \
        + torch.exp(-cum) * torch.einsum("bhcji,bhcjn->bhcin", lower, q)
    dr = dr_nb + u32 * k32 * diag
    dk = dk_nb + u32 * r32 * diag
    dv = torch.einsum("bhcji,bhcjm->bhcim", A, do32) \
        + torch.einsum("bhcin,bhcnm->bhcim", kd, Gc)
    du = (r32 * k32 * diag).sum((0, 2, 3))
    # 4. the decay's gradient: in-chunk reverse sums, then each chunk's
    # carry, rowsum(G^c * S_{c+1}) with S_{c+1} = diag(d_c) S_c + U_c
    a = r32 * dr_nb
    bb = k32 * dk_nb
    rev = lambda x: torch.flip(torch.cumsum(torch.flip(x, [3]), 3), [3])  # noqa: E731
    gv = torch.einsum("bhcnm,bhcim->bhcin", Gc, v32)
    carry = dec * (Gc * Sc).sum(-1) + (kd * gv).sum(3)       # (B, H, C, N)
    dlw = rev(a) - a - rev(bb) + carry[:, :, :, None]

    def seq(x):
        return x.reshape(b, h, nc * L, n)[:, :, :t]

    return (seq(dr).to(r.dtype), seq(dk).to(k.dtype), seq(dv).to(v.dtype),
            seq(dlw), du, None if S0 is None else G)
