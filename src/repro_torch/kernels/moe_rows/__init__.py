"""The MoE layer's rows between tokens and expert slots (dispatch, and the
weighted combine), both ways."""
from . import ops, ref  # noqa: F401
