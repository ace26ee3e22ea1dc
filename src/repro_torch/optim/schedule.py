"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_frac: float = 0.1) -> np.float32:
    """Linear warmup then cosine decay; returns a scale in [min_frac, 1].

    A host scalar in float32, with the JAX function's operations in its
    order and types (its Python floats enter as float32 constants).  The
    cosine is libm's, correctly rounded to float32; XLA's own float32 cosine
    may differ from it in the last bit, so the two schedules agree to one
    float32 ulp."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(warmup, 1)), f32(1.0))
    prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(min_frac) + f32((1.0 - min_frac) * 0.5) * (
        f32(1.0) + f32(np.cos(np.float64(f32(np.pi) * prog))))
    return f32(warm * cos)
