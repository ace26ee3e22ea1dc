"""Pairwise Euclidean distances (CRCH cluster affinity)."""
from . import ops, ref  # noqa: F401
