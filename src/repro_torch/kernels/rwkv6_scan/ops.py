"""Wrapper of the WKV6 kernel (``csrc/wkv6.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``wkv6.launches`` counts the launches.

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

from .. import _build
from . import ref

__all__ = ["wkv6", "HEAD_SIZES", "CHUNK"]

HEAD_SIZES = (64, 128)
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
    (B, H, N, N) fp32).  Any T: the kernel masks the ragged last chunk."""
    _check(r, k, v, log_w, u, S0)
    if r.device.type == "cpu":
        return ref.wkv6(r, k, v, log_w, u, S0)
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
    return o, s_out


wkv6.launches = 0
