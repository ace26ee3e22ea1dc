"""Gated linear recurrence h_t = a_t h_{t-1} + b_t (RG-LRU)."""
from . import ops, ref  # noqa: F401
