"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32 experts top-8, GQA kv=8."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    block_type="llama", norm_type="rmsnorm", tie_embeddings=True,
    n_experts=32, top_k=8,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
        n_experts=4, top_k=2)
