"""Wrapper of the RG-LRU scan kernel (``csrc/lru_scan.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``lru_scan.launches`` and ``lru_scan_bwd.launches``
count the launches; each launch reports its work to ``_cost``.

The kernel scans time in chunks of ``CHUNK`` steps in two passes (chunk
summaries, then each chunk from its carry-in); ``ref.lru_scan_chunked``
does the same arithmetic in PyTorch.  The backward kernel runs the same two
passes backward in time (``ref.lru_scan_backward``).  Under autograd
:func:`lru_scan` goes through :class:`_LruScan`, whose backward is
:func:`lru_scan_bwd`; without a gradient it is the forward alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _cost
from . import ref

__all__ = ["lru_scan", "lru_scan_bwd", "CHUNK"]

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


@functools.cache
def _bwd_fn():
    lib = _build.load("lru_scan")
    fn = lib.lru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lru_scan(a, b, h0=None):
    """a, b: (B, S, W); h0: (B, W) or None (zero state).  Returns
    (h (B, S, W) fp32, h_last (B, W) fp32).  Differentiable in a, b and h0
    (:class:`_LruScan`)."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        return _LruScan.apply(a, b, h0)
    return _lru_scan(a, b, h0)


def _lru_scan(a, b, h0=None):
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a, b must share one (B, S, W) shape: "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, w):
        raise ValueError(f"h0 must be {(bsz, w)}, got {tuple(h0.shape)}")
    if b.device != a.device or (h0 is not None and h0.device != a.device):
        raise ValueError("lru_scan inputs must lie on one device")
    if _cost.shape_only(a):
        _report_fwd(bsz, s, w, h0)
        return (a.new_empty((bsz, s, w), dtype=torch.float32),
                a.new_empty((bsz, w), dtype=torch.float32))
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
    _report_fwd(bsz, s, w, h0)
    return h, h_last


def _report_fwd(bsz, s, w, h0):
    if _cost.active():
        _cost.report("lru_scan", 2 * bsz * s * w,
                     4 * (3 * bsz * s * w
                          + (1 if h0 is None else 2) * bsz * w))


lru_scan.launches = 0


def lru_scan_bwd(a, h, dh, dh_last=None, h0=None):
    """(da, db, dh0) of :func:`lru_scan` at output gradients ``dh``
    (B, S, W) and ``dh_last`` (B, W) (None: zero), from ``a`` and the
    forward's fp32 ``h``; all fp32, ``dh0`` None when ``h0`` is None."""
    bsz, s, w = a.shape
    if h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"a, h, dh must share one (B, S, W) shape: "
                         f"{tuple(a.shape)}, {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}")
    for x in (dh_last, h0):
        if x is not None and tuple(x.shape) != (bsz, w):
            raise ValueError(f"dh_last and h0 must be {(bsz, w)}, got "
                             f"{tuple(x.shape)}")
    if any(x is not None and x.device != a.device
           for x in (h, dh, dh_last, h0)):
        raise ValueError("lru_scan_bwd inputs must lie on one device")
    if _cost.shape_only(a):
        _report_bwd(bsz, s, w, h0)
        f32 = dict(dtype=torch.float32)
        return (a.new_empty(a.shape, **f32), a.new_empty(a.shape, **f32),
                None if h0 is None else a.new_empty((bsz, w), **f32))
    if a.device.type == "cpu":
        return ref.lru_scan_backward(a, h, dh, dh_last, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan backward kernel for {a.device}")
    if s == 0:
        raise ValueError("lru_scan_bwd needs at least one time step")
    a, h, dh = (x.to(torch.float32).contiguous() for x in (a, h, dh))
    dh_last, h0 = (None if x is None else x.to(torch.float32).contiguous()
                   for x in (dh_last, h0))
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    scratch = torch.empty((2, bsz, -(-s // CHUNK), w), dtype=torch.float32,
                          device=a.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        err = _bwd_fn()(a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(),
                        ptr(dh_last), da.data_ptr(), db.data_ptr(),
                        ptr(dh0), scratch.data_ptr(), bsz, s, w, CHUNK,
                        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    lru_scan_bwd.launches += 1
    _report_bwd(bsz, s, w, h0)
    return da, db, dh0


def _report_bwd(bsz, s, w, h0):
    # a, h, dh read, da and db written; h0, dh_last, dh0
    if _cost.active():
        _cost.report("lru_scan_bwd", 3 * bsz * s * w,
                     4 * (5 * bsz * s * w
                          + (0 if h0 is None else 3) * bsz * w))


lru_scan_bwd.launches = 0


class _LruScan(torch.autograd.Function):
    """The scan with the backward kernel as its gradient: the forward keeps
    a, h0 and its fp32 h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _lru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        # an unused output's gradient arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        ctx.dtypes = (a.dtype, b.dtype, None if h0 is None else h0.dtype)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        da, db, dh0 = lru_scan_bwd(a, h, dh, dh_last, h0)
        ta, tb, th = ctx.dtypes
        return (da.to(ta), db.to(tb),
                None if dh0 is None else dh0.to(th))
