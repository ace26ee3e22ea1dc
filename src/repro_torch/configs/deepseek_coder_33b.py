"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch dense, GQA kv=8."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256,
    block_type="llama", norm_type="rmsnorm", rope_theta=100_000.0,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-coder-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
