"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
a kernel or raises.  ``flash_attention.launches`` counts the launches.

bf16 runs on the tensor cores (wgmma, with K/V tiles brought in by TMA);
TMA needs every base pointer and every (batch, head, seq) stride of q, k, v
16-byte aligned, and the wrapper raises otherwise (every caller in the port
passes aligned tensors).  The kernel takes 128 query rows a block where the
head dim is at most 128 and that grid covers every SM once, else 64; the
result has the same bits either way.  fp32 runs on the SIMT kernel at full
fp32 precision, with no alignment condition.

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

from .. import _build
from . import ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int64] * 12
                   + [ctypes.c_void_p])
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


def _check_tma_aligned(*xs):
    for x in xs:
        if x.data_ptr() % 16 or any(x.stride(i) * x.element_size() % 16
                                    for i in range(3)):
            raise ValueError(
                f"the bf16 kernel reads by TMA and needs a 16-byte aligned "
                f"base and (batch, head, seq) strides; got a tensor at "
                f"offset {x.data_ptr() % 16} with strides {x.stride()}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  Both ragged sequence edges are masked by the kernel.
    ``window > 0`` (causal only) keeps the keys with ``q - k < window``."""
    _check(q, k, v)
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window} needs causal attention and must "
                         f"be >= 0")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
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
    if sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma_aligned(q, k, v)
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(bf16), b, h, kv, sq, sk, d,
            int(causal), int(window), 1.0 / math.sqrt(d),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
