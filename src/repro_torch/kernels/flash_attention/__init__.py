"""Flash attention (forward and backward, GQA, causal, sliding-window or
full)."""
from . import ops, ref  # noqa: F401
