"""repro_torch.distributed — train, prefill and serve step factories."""
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]
