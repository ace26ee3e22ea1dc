"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

A CPU tensor goes to the plain versions in ``ref.py``; a CUDA tensor
launches a kernel or raises.  ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count the launches (each reports its work
to ``_cost``).  :func:`attention` is
the differentiable entry the model calls: under autograd its forward keeps
q, k, v, the output and the row log-sum-exp, and its backward is the
backward kernels (D = 64, 128 or 256); without a gradient it is
:func:`flash_attention`.

bf16 runs on the tensor cores in both directions (wgmma, with tiles brought
in by TMA); TMA needs every base pointer and every (batch, head, seq)
stride of q, k, v (and, backward, o) 16-byte aligned, and the wrapper
raises otherwise (every caller in the port passes aligned tensors); a
misaligned output gradient is copied.  The forward takes 128 query rows a
block where the head dim is at most 128 and that grid covers every SM
once, else 64; the result has the same bits either way.  The bf16
backward rounds P and dS to bf16 before their products
(``ref.attention_backward_rounded`` is its arithmetic on the CPU) at every
head dim; at D = 256 its dK/dV pass runs as a dV pass and a dK pass, since
one warpgroup's registers cannot hold both 256-wide accumulators.  fp32
runs on the SIMT kernels with every product in fp32
(``ref.attention_backward``), with no alignment condition.

The kernels read q, k, v through their (batch, head, seq) strides, so the
model passes ``(B, S, H, D)`` projections as transposed views without a
copy, and write the output into a ``(B, Sq, H, D)`` buffer returned as a
``(B, H, Sq, D)`` view: ``out.transpose(1, 2)`` is contiguous.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build, _cost
from . import ref

__all__ = ["attention", "flash_attention", "flash_attention_bwd",
           "HEAD_DIMS", "BWD_HEAD_DIMS"]

HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
#: head dims whose bf16 backward runs on the tensor cores (TMA-aligned)
TC_BWD_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int64] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-d (B, H|KV, S, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads do not divide into "
                         f"{k.shape[1]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in {_DTYPES}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must lie on one device")


def _tma_aligned(x):
    return not (x.data_ptr() % 16 or any(x.stride(i) * x.element_size() % 16
                                         for i in range(3)))


def _check_tma_aligned(*xs):
    for x in xs:
        if not _tma_aligned(x):
            raise ValueError(
                f"the bf16 kernel reads by TMA and needs a 16-byte aligned "
                f"base and (batch, head, seq) strides; got a tensor at "
                f"offset {x.data_ptr() % 16} with strides {x.stride()}")


def _check_window(causal, window):
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window} needs causal attention and must "
                         f"be >= 0")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  Both ragged sequence edges are masked by the kernel.
    ``window > 0`` (causal only) keeps the keys with ``q - k < window``.
    ``return_lse``: also each row's log-sum-exp of the scaled scores,
    (B, H, Sq) fp32 (the output's bits are the same either way)."""
    _check(q, k, v)
    _check_window(causal, window)
    if _cost.shape_only(q):
        return _fwd_shapes(q, k, causal, window, return_lse)
    if q.device.type == "cpu":
        out = ref.attention(q, k, v, causal=causal, window=window)
        if return_lse:
            return out, ref.attention_lse(q, k, v, causal=causal,
                                          window=window)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k, v must be contiguous")
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if sq == 0:
        return (out, lse) if return_lse else out
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma_aligned(q, k, v)
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, int(bf16),
            b, h, kv, sq, sk, d, int(causal), int(window), 1.0 / math.sqrt(d),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    _report_fwd(q, k, causal, window, return_lse)
    return (out, lse) if return_lse else out


def _report_fwd(q, k, causal, window, return_lse):
    if _cost.active():
        b, h, sq, d = q.shape
        kv, sk = k.shape[1], k.shape[2]
        pairs = _cost.attended_pairs(sq, causal, window, sk)
        _cost.report("flash_attention", 4 * b * h * pairs * d,
                     q.element_size() * (2 * b * h * sq * d
                                         + 2 * b * kv * sk * d)
                     + (4 * b * h * sq if return_lse else 0))


def _fwd_shapes(q, k, causal, window, return_lse):
    """The forward's outputs without a launch (a fake or meta ``q``), its
    work reported."""
    b, h, sq, d = q.shape
    out = q.new_empty((b, sq, h, d)).transpose(1, 2)
    _report_fwd(q, k, causal, window, return_lse)
    if return_lse:
        return out, q.new_empty((b, h, sq), dtype=torch.float32)
    return out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` at output gradient ``do``,
    from its output ``o`` and row log-sum-exp ``lse`` ((B, H, Sq) fp32), in
    the inputs' dtype.  dq is a ``(B, H, Sq, D)`` view of a contiguous
    ``(B, Sq, H, D)`` buffer and dk, dv views of ``(B, Sk, KV, D)`` ones, so
    the gradients of the model's transposed projection views come back
    contiguous without a copy.  On CUDA the head dim must be 64, 128 or
    256; bf16 runs on the tensor cores and needs q, k, v and o 16-byte
    aligned (it raises otherwise; ``do`` is copied where it is not)."""
    _check(q, k, v)
    _check_window(causal, window)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) fp32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if _cost.shape_only(q):
        _report_bwd(q, k, causal, window)
        return (q.new_empty((b, sq, h, d)).transpose(1, 2),
                k.new_empty((b, sk, kv, d)).transpose(1, 2),
                k.new_empty((b, sk, kv, d)).transpose(1, 2))
    if q.device.type == "cpu":
        return ref.attention_backward(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention backward kernel for "
                         f"{q.device}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the backward kernel's "
                         f"{BWD_HEAD_DIMS}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and do must have q's dtype")
    if any(x.device != q.device for x in (o, lse, do)):
        raise ValueError("q, k, v, o, lse, do must lie on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k, v must be contiguous")
    if o.stride(3) != 1:
        raise ValueError("the head dim of o must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    tma = bf16 and d in TC_BWD_HEAD_DIMS
    if tma:
        _check_tma_aligned(q, k, v, o)
    if do.stride(3) != 1 or (tma and not _tma_aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, kv, d), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if sq == 0 or sk == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(x.stride(i) for x in
                                      (q, k, v, o, do, dq, dk, dv)
                                      for i in range(3)))
    with torch.cuda.device(q.device):
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(bf16),
            b, h, kv, sq, sk, d, int(causal), int(window), 1.0 / math.sqrt(d),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    _report_bwd(q, k, causal, window)
    return dq, dk, dv


def _report_bwd(q, k, causal, window):
    # q, o, dO and dq (B, H, Sq, D); k, v, dk, dv (B, KV, Sk, D); lse
    if _cost.active():
        b, h, sq, d = q.shape
        kv, sk = k.shape[1], k.shape[2]
        pairs = _cost.attended_pairs(sq, causal, window, sk)
        _cost.report("flash_attention_bwd", 10 * b * h * pairs * d,
                     q.element_size() * (4 * b * h * sq * d
                                         + 4 * b * kv * sk * d)
                     + 4 * b * h * sq)


flash_attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    """Flash attention with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """:func:`flash_attention`, differentiable: when a gradient is wanted
    the forward also writes the row log-sum-exp and the backward runs
    :func:`flash_attention_bwd` (the plain versions on the CPU).  On CUDA a
    head dim outside ``BWD_HEAD_DIMS`` raises before any launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cuda" and q.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"head dim {q.shape[-1]} has no backward "
                             f"kernel (it takes {BWD_HEAD_DIMS})")
        return _Attention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
