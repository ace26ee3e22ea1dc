"""repro_torch.data — the synthetic token pipeline (a numpy copy)."""
from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
