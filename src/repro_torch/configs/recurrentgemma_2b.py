"""recurrentgemma-2b [arXiv:2402.19427]: RG-LRU + local attention, pattern
(rec, rec, attn), window 2048, MQA kv=1, head_dim 256."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256_000, head_dim=256,
    block_type="llama", norm_type="rmsnorm", tie_embeddings=True,
    rglru=True, rec_per_attn=2, window=2048, conv_width=4, lru_width=2560,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-tiny", n_layers=5, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=32,
        window=16, lru_width=64)
