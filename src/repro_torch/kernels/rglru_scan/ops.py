"""Wrapper of the RG-LRU scan kernel (``csrc/lru_scan.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``lru_scan.launches`` counts the launches.

The kernel scans time in chunks of ``CHUNK`` steps in two passes (chunk
summaries, then each chunk from its carry-in); ``ref.lru_scan_chunked``
does the same arithmetic in PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["lru_scan", "CHUNK"]

#: time steps per chunk of the two-pass scan
CHUNK = 128


@functools.cache
def _fn():
    lib = _build.load("lru_scan")
    fn = lib.lru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lru_scan(a, b, h0=None):
    """a, b: (B, S, W); h0: (B, W) or None (zero state).  Returns
    (h (B, S, W) fp32, h_last (B, W) fp32)."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a, b must share one (B, S, W) shape: "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, w):
        raise ValueError(f"h0 must be {(bsz, w)}, got {tuple(h0.shape)}")
    if b.device != a.device or (h0 is not None and h0.device != a.device):
        raise ValueError("lru_scan inputs must lie on one device")
    if a.device.type == "cpu":
        return ref.lru_scan(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan kernel for {a.device}")
    if s == 0:
        raise ValueError("lru_scan needs at least one time step")
    a, b = (x.to(torch.float32).contiguous() for x in (a, b))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    scratch = torch.empty((2, bsz, -(-s // CHUNK), w), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = _fn()(a.data_ptr(), b.data_ptr(),
                    None if h0 is None else h0.data_ptr(), h.data_ptr(),
                    h_last.data_ptr(), scratch.data_ptr(), bsz, s, w, CHUNK,
                    torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error {err}")
    lru_scan.launches += 1
    return h, h_last


lru_scan.launches = 0
