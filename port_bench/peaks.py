"""Published peaks of the cards the benchmark knows, and the roofline bound.

Copied from ``chip_smoke.py`` (commit 93b320d, ``PEAK_BYTES_S``,
``PEAK_FLOPS_S`` and ``add_bound``): NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W.  A card that is not listed has no
peak here, and the metrics that need one say nothing.
"""
from __future__ import annotations

__all__ = ["PEAKS", "peak", "least_seconds"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12,
                              "float32": 67e12, "bytes_s": 3.35e12},
}


def peak(kind: str | None) -> dict | None:
    return PEAKS.get(kind or "")


def least_seconds(flops: float, nbytes: float, p: dict,
                  dtype: str = "bfloat16") -> float:
    """The card's least time for the work: the larger of the operations at
    the peak rate for ``dtype`` and the bytes at the memory rate."""
    return max(flops / p[dtype], nbytes / p["bytes_s"])
