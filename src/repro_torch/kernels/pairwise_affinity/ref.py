"""Plain PyTorch version of the pairwise-distance kernel.

Mirrors ``repro.kernels.pairwise_affinity.ref``: the Gram expansion in fp32,
``sqrt(max(d2, 0))``.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_distance"]


def pairwise_distance(points: torch.Tensor) -> torch.Tensor:
    """D[i, j] = ||x_i - x_j||_2 for points (N, F) -> (N, N) fp32."""
    x = points.to(torch.float32)
    sq = torch.sum(x * x, dim=-1)
    gram = x @ x.T
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    return torch.sqrt(torch.clamp(d2, min=0.0))
