"""PCA with a coverage-of-variance stopping rule (Algorithm 1, steps 2-10).

Counterpart of ``repro.core.pca``: whiten (mean-subtract, standardise with
the population std), then keep principal components until the cumulative
explained variance reaches the threshold.  The SVD runs in fp32 with
``torch.linalg.svd`` on the requested device; the small results come back
as numpy.  The sign of each component is arbitrary, as in JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PCAResult", "fit_pca", "project"]


@dataclasses.dataclass
class PCAResult:
    mean: np.ndarray            # (F,)
    scale: np.ndarray           # (F,)
    components: np.ndarray      # (K, F) orthonormal rows
    explained_ratio: np.ndarray  # (K,)
    cov: float                  # cumulative coverage of variance actually reached
    projected: np.ndarray       # (N, K)


def _svd_whitened(x: torch.Tensor):
    mean = x.mean(0)
    std = x.std(0, correction=0)       # population std, as jnp.std
    std = torch.where(std < 1e-12, torch.ones_like(std), std)
    xw = (x - mean) / std
    # economy SVD of the whitened data: principal axes = rows of vt
    _, s, vt = torch.linalg.svd(xw, full_matrices=False)
    var = (s * s) / max(x.shape[0] - 1, 1)
    ratio = var / torch.clamp(var.sum(), min=1e-12)
    return mean, std, vt, ratio, xw


def fit_pca(features: np.ndarray, threshold: float = 0.35, *,
            device="cuda") -> PCAResult:
    """Fit PCA keeping the fewest components with sum(ratio) >= threshold."""
    x = torch.as_tensor(np.asarray(features, dtype=np.float64),
                        dtype=torch.float32, device=device)
    mean, std, vt, ratio, xw = _svd_whitened(x)
    ratio_np = ratio.cpu().numpy()
    cum = np.cumsum(ratio_np)
    k = int(np.searchsorted(cum, threshold) + 1)
    k = min(max(k, 1), ratio_np.shape[0])
    comps = vt[:k]
    proj = (xw @ comps.T).cpu().numpy()
    return PCAResult(
        mean=mean.cpu().numpy(),
        scale=std.cpu().numpy(),
        components=comps.cpu().numpy(),
        explained_ratio=ratio_np[:k],
        cov=float(cum[k - 1]),
        projected=proj,
    )


def project(res: PCAResult, features: np.ndarray) -> np.ndarray:
    xw = (np.asarray(features) - res.mean) / res.scale
    return xw @ res.components.T
