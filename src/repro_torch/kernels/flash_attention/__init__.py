"""Flash attention (forward, GQA, causal or full)."""
from . import ops, ref  # noqa: F401
