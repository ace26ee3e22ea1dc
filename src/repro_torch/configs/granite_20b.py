"""granite-20b [arXiv:2405.04324]: llama-arch code model, MQA (kv=1)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    block_type="llama", norm_type="layernorm", use_bias=True,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-20b-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256)
