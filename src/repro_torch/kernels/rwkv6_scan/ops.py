"""Wrapper of the WKV6 kernel (``csrc/wkv6.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``wkv6.launches`` and ``wkv6_bwd.launches`` count
the launches (each reports its work to ``_cost``).  :func:`wkv6` is
differentiable: under autograd it goes through :class:`_WKV6`, whose
forward keeps the kernel's scratch (the state entering each chunk) and
whose backward is :func:`wkv6_bwd` (head size 64 on the card); without a
gradient it is the forward alone.

The kernel reads r, k, v and log_w through their (batch, head, token)
strides, so the model passes its ``(B, T, H, N)`` projections as transposed
views without a copy, and writes its output into a ``(B, T, H, N)`` buffer
returned as a ``(B, H, T, N)`` view: ``o.transpose(1, 2)`` is contiguous.
It runs as a chunk-parallel scan over chunks of L = ``CHUNK`` tokens (what
is local to each chunk, a fold over chunks, outputs; three passes from one
C call) with an fp32 scratch that the wrapper allocates at the size the
library's ``wkv6_scratch_floats`` gives (the kernel owns its layout);
``ref.wkv6_chunked`` is the same arithmetic on the CPU.  The kernel reads
and writes rows of 4 elements as vectors, so a view whose base or (batch,
head, token) strides are off that grid is copied first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _cost
from . import ref

__all__ = ["wkv6", "wkv6_forward", "wkv6_bwd", "HEAD_SIZES",
           "BWD_HEAD_SIZES", "CHUNK"]

HEAD_SIZES = (64, 128)
BWD_HEAD_SIZES = (64,)   # RWKV-6's head size
CHUNK = 16   # tokens a chunk; the library's wkv6_chunk_tokens must agree
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    lib = _build.load("wkv6")
    lib.wkv6_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                             + [ctypes.c_int64] * 15 + [ctypes.c_void_p])
    lib.wkv6_fwd.restype = ctypes.c_int
    lib.wkv6_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.wkv6_scratch_floats.restype = ctypes.c_int64
    lib.wkv6_chunk_tokens.restype = ctypes.c_int
    lib.wkv6_bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p] * 2)
    lib.wkv6_bwd.restype = ctypes.c_int
    lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.wkv6_bwd_scratch_floats.restype = ctypes.c_int64
    if lib.wkv6_chunk_tokens() != CHUNK:
        raise RuntimeError(f"csrc/wkv6.cu chunks {lib.wkv6_chunk_tokens()} "
                           f"tokens, ops.CHUNK says {CHUNK}")
    return lib


def _aligned(x):
    """``x`` where its base and (batch, head, token) strides are on the
    4-element grid of the kernel's vector accesses, else a contiguous copy."""
    if x.data_ptr() % (4 * x.element_size()) or any(
            s % 4 for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _check(r, k, v, log_w, u, S0):
    if r.ndim != 4 or r.shape != k.shape or r.shape != v.shape \
            or r.shape != log_w.shape:
        raise ValueError(f"r, k, v, log_w must share one (B, H, T, N) shape: "
                         f"{[tuple(x.shape) for x in (r, k, v, log_w)]}")
    b, h, _, n = r.shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u must be (H, N) = {(h, n)}, got {tuple(u.shape)}")
    if S0 is not None and tuple(S0.shape) != (b, h, n, n):
        raise ValueError(f"S0 must be {(b, h, n, n)}, got {tuple(S0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise ValueError(f"r, k, v must share a dtype in {_DTYPES}")
    tensors = [r, k, v, log_w, u] + ([] if S0 is None else [S0])
    if any(x.device != r.device for x in tensors):
        raise ValueError("wkv6 inputs must lie on one device")


def wkv6(r, k, v, log_w, u, S0=None):
    """r, k, v, log_w: (B, H, T, N); u: (H, N); S0: (B, H, N, N) fp32 or
    None (zero state).  Returns (o (B, H, T, N) in r's dtype, S_final
    (B, H, N, N) fp32).  Any T: the kernel masks the ragged last chunk.
    Differentiable in every input (:class:`_WKV6`)."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (r, k, v, log_w, u, S0)):
        return _WKV6.apply(r, k, v, log_w, u, S0)
    return wkv6_forward(r, k, v, log_w, u, S0)[:2]


def wkv6_forward(r, k, v, log_w, u, S0=None):
    """:func:`wkv6`'s forward alone: (o, S_final, scratch), the scratch
    the kernel left (the backward's input; None on the CPU)."""
    _check(r, k, v, log_w, u, S0)
    if _cost.shape_only(r):
        b, h, t, n = r.shape
        _report_fwd(b, h, t, n, r.element_size(), S0)
        return (r.new_empty((b, t, h, n)).transpose(1, 2),
                r.new_empty((b, h, n, n), dtype=torch.float32), None)
    if r.device.type == "cpu":
        return (*ref.wkv6(r, k, v, log_w, u, S0), None)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    b, h, t, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} not in the kernel's {HEAD_SIZES}")
    if t and any(x.stride(3) != 1 for x in (r, k, v, log_w)):
        raise ValueError("the channel dim of r, k, v, log_w must be "
                         "contiguous")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32 or (
            S0 is not None and S0.dtype != torch.float32):
        raise ValueError("log_w, u and S0 must be float32")
    r, k, v, log_w = (_aligned(x) for x in (r, k, v, log_w))
    u = u.contiguous()
    S0 = None if S0 is None else _aligned(S0.contiguous())
    o = torch.empty((b, t, h, n), dtype=r.dtype,
                    device=r.device).transpose(1, 2)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    lib = _lib()
    scratch = torch.empty(lib.wkv6_scratch_floats(b, h, t, n),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), None if S0 is None else S0.data_ptr(),
            o.data_ptr(), s_out.data_ptr(), scratch.data_ptr(),
            int(r.dtype == torch.bfloat16), b, h, t, n,
            *(s for x in (r, k, v, log_w, o) for s in x.stride()[:3]),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    _report_fwd(b, h, t, n, r.element_size(), S0)
    return o, s_out, scratch


def _report_fwd(b, h, t, n, esize, S0):
    state = (1 if S0 is None else 2) * 4 * b * h * n * n
    if _cost.active():
        _cost.report("wkv6", b * h * t * (4 * n * n + 3 * n),
                     (4 * esize + 4) * b * h * t * n + 4 * h * n
                     + state)


wkv6.launches = 0


def _layout_like_forward(b, t, h, n, dtype, device):
    """A (B, H, T, N) view of a contiguous (B, T, H, N) buffer, as the
    forward writes o: the gradients of the model's transposed projection
    views come back contiguous."""
    return torch.empty((b, t, h, n), dtype=dtype,
                       device=device).transpose(1, 2)


def wkv6_bwd(r, k, v, log_w, u, do, S0=None, dS=None, *, scratch=None):
    """Gradient of :func:`wkv6` at output gradient ``do`` (B, H, T, N) and
    final-state gradient ``dS`` ((B, H, N, N) fp32 or None: zero).  Returns
    (dr, dk, dv in r's dtype, dlog_w (B, H, T, N) fp32, du (H, N) fp32,
    dS0 (B, H, N, N) fp32 or None when S0 is None).  On CUDA it takes the
    forward's ``scratch`` (:func:`wkv6_forward`); the head size must be 64.
    The kernel runs two passes (the state gradient's fold, then each
    chunk's gradients) and leaves each chunk's share of du, which this
    sums over chunks and the batch."""
    _check(r, k, v, log_w, u, S0)
    if do.shape != r.shape:
        raise ValueError(f"do must have r's shape {tuple(r.shape)}, got "
                         f"{tuple(do.shape)}")
    b, h, t, n = r.shape
    if dS is not None and tuple(dS.shape) != (b, h, n, n):
        raise ValueError(f"dS must be {(b, h, n, n)}, got "
                         f"{tuple(dS.shape)}")
    if any(x is not None and x.device != r.device for x in (do, dS)):
        raise ValueError("wkv6_bwd inputs must lie on one device")
    if _cost.shape_only(r):
        _report_bwd(b, h, t, n, r.element_size(), S0)
        f32 = dict(dtype=torch.float32)
        return (*(_layout_like_forward(b, t, h, n, dt, r.device)
                  for dt in (r.dtype,) * 3 + (torch.float32,)),
                r.new_empty((h, n), **f32),
                None if S0 is None else r.new_empty((b, h, n, n), **f32))
    if r.device.type == "cpu":
        return ref.wkv6_backward(r, k, v, log_w, u, do, S0, dS)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 backward kernel for {r.device}")
    if n not in BWD_HEAD_SIZES:
        raise ValueError(f"head size {n} not in the backward kernel's "
                         f"{BWD_HEAD_SIZES}")
    if scratch is None:
        raise ValueError("the backward kernel needs the forward's scratch: "
                         "see wkv6_forward")
    if do.dtype != r.dtype:
        raise ValueError("do must have r's dtype")
    lib = _lib()
    if scratch.numel() != lib.wkv6_scratch_floats(b, h, t, n):
        raise ValueError("scratch is not the forward's for this shape")
    dr, dk, dv = (_layout_like_forward(b, t, h, n, r.dtype, r.device)
                  for _ in range(3))
    dlw = _layout_like_forward(b, t, h, n, torch.float32, r.device)
    dS0 = None if S0 is None else torch.empty(
        (b, h, n, n), dtype=torch.float32, device=r.device)
    if t == 0:
        zero = torch.zeros((h, n), dtype=torch.float32, device=r.device)
        if dS0 is not None:
            dS0.copy_(torch.zeros_like(dS0) if dS is None else dS)
        return dr, dk, dv, dlw, zero, dS0
    r, k, v, log_w = (_aligned(x) for x in (r, k, v, log_w))
    if do.stride(3) != 1:
        do = do.contiguous()
    do = _aligned(do)
    u = u.contiguous()
    dS = None if dS is None else dS.to(torch.float32).contiguous()
    bscratch = torch.empty(lib.wkv6_bwd_scratch_floats(b, h, t, n),
                           dtype=torch.float32, device=r.device)
    du_part = torch.empty((b, h, -(-t // CHUNK), n), dtype=torch.float32,
                          device=r.device)
    strides = (ctypes.c_int64 * 27)(*(s for x in (r, k, v, log_w, do, dr,
                                                  dk, dv, dlw)
                                      for s in x.stride()[:3]))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(r.device):
        err = lib.wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), do.data_ptr(), ptr(dS), scratch.data_ptr(), bscratch.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du_part.data_ptr(),
            ptr(dS0), int(r.dtype == torch.bfloat16), b, h, t, n,
            ctypes.addressof(strides),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    _report_bwd(b, h, t, n, r.element_size(), S0)
    # du: the chunks' shares summed over chunks and the batch, in torch's
    # fixed order for this shape
    return dr, dk, dv, dlw, du_part.sum((0, 2)), dS0


def _report_bwd(b, h, t, n, esize, S0):
    # r, k, v, dO read and dr, dk, dv written in r's dtype; log_w read and
    # dlog_w written in fp32; u, du.  Operations of the chunked form: per
    # token and head N^2 (q^T dO) + 3 N^2 (S_c dO, G v, kd G) + 4 L N FMA,
    # and the fold's N^2 per chunk
    state = (0 if S0 is None else 3) * 4 * b * h * n * n
    if _cost.active():
        _cost.report("wkv6_bwd",
                     2 * b * h * (t * (4 * n * n + 4 * CHUNK * n)
                                  + -(-t // CHUNK) * n * n),
                     (7 * esize + 8) * b * h * t * n + 8 * h * n
                     + state)


wkv6_bwd.launches = 0


class _WKV6(torch.autograd.Function):
    """WKV6 with the backward kernel as its gradient: the forward keeps its
    inputs and the kernel's scratch."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, S0):
        o, S_final, scratch = wkv6_forward(r, k, v, log_w, u, S0)
        ctx.save_for_backward(r, k, v, log_w, u, S0, scratch)
        # an unused output's gradient arrives as None, not as zeros: the
        # training path never reads S_final, so the kernel skips dS
        ctx.set_materialize_grads(False)
        return o, S_final

    @staticmethod
    def backward(ctx, do, dS):
        r, k, v, log_w, u, S0, scratch = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        dr, dk, dv, dlw, du, dS0 = wkv6_bwd(r, k, v, log_w, u, do, S0, dS,
                                            scratch=scratch)
        return (dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype),
                None if dS0 is None else dS0.to(S0.dtype))
