"""Int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compression``).

For the cross-pod gradient reduction the pod link is slow; compressing
gradients to int8 with per-tensor scales cuts its bytes 4x against fp32 (2x
against bf16).  Error feedback keeps the quantization residual locally so
the compression bias vanishes over steps (Seide et al.; Karimireddy et al.).

Every step is the JAX package's fp32 arithmetic in its order (the scale
``max(max|g|, 1e-12) / 127``, ``round`` half to even, the clip, the
residual ``target - q * scale``), so a tensor gives JAX's bits.
"""
from __future__ import annotations

import torch

from ..tree import tree_map

__all__ = ["compress_int8", "decompress_int8", "compress_tree_with_feedback",
           "decompress_tree"]


def compress_int8(g: torch.Tensor):
    """Returns (q int8, scale: a 0-d fp32 tensor on g's device).  Symmetric
    per-tensor quantization."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree_with_feedback(grads, residuals):
    """Quantize grads + residuals; returns (quantized, scales,
    new_residuals), three trees of ``grads``' structure."""
    def one(g, r):
        target = g.to(torch.float32) + r
        q, s = compress_int8(target)
        return q, s, target - decompress_int8(q, s)

    flat = tree_map(one, grads, residuals)    # a (q, s, r) tuple a leaf
    return tuple(tree_map(lambda t, i=i: t[i], flat) for i in range(3))


def decompress_tree(q, s):
    return tree_map(decompress_int8, q, s)
