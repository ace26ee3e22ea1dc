"""Flash attention (forward, GQA, causal, sliding-window or full)."""
from . import ops, ref  # noqa: F401
