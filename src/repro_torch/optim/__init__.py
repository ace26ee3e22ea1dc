"""repro_torch.optim — AdamW and the learning-rate schedule.

Counterpart of ``repro.optim`` without gradient compression (which waits for
the cross-pod slice)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    state_from_jax)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "state_from_jax"]
