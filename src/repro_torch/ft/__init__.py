"""repro_torch.ft — failure sampling and the dynamic snapshot interval."""
from .coordinator import FaultInjector
from .interval import DynamicInterval

__all__ = ["DynamicInterval", "FaultInjector"]
