"""WKV6 linear recurrence (RWKV-6 time mixing) with entering/final state."""
from . import ops, ref  # noqa: F401
