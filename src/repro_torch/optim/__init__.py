"""repro_torch.optim — AdamW, the learning-rate schedule and int8 gradient
compression with error feedback (counterpart of ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    state_from_jax)
from .grad_compression import (compress_int8, compress_tree_with_feedback,
                               decompress_int8, decompress_tree)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "compress_int8", "compress_tree_with_feedback", "cosine_schedule",
           "decompress_int8", "decompress_tree", "global_norm",
           "state_from_jax"]
