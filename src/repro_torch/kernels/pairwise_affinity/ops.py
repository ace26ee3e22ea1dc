"""Wrapper of the pairwise-distance kernel (``csrc/pairwise_distance.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``pairwise_distance.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["pairwise_distance"]


@functools.cache
def _fn():
    lib = _build.load("pairwise_distance")
    fn = lib.pairwise_distance_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pairwise_distance(points: torch.Tensor) -> torch.Tensor:
    """(N, F) points -> (N, N) fp32 Euclidean distances."""
    if points.ndim != 2:
        raise ValueError(f"points must be (N, F), got {tuple(points.shape)}")
    if points.device.type == "cpu":
        return ref.pairwise_distance(points)
    if points.device.type != "cuda":
        raise ValueError(f"no pairwise-distance kernel for {points.device}")
    x = points.to(torch.float32).contiguous()
    n, f = x.shape
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), out.data_ptr(), n, f,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_distance kernel launch failed: CUDA "
                           f"error {err}")
    pairwise_distance.launches += 1
    return out


pairwise_distance.launches = 0
