"""rwkv6-3b "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay,
head size 64 (40 heads), layernorm."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    block_type="llama", norm_type="layernorm", use_bias=False,
    rwkv=True,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-tiny", n_layers=2, d_model=128,
        n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=256)
