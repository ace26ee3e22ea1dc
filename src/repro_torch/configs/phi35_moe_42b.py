"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]:
16 experts top-2, GQA kv=8."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    block_type="llama", norm_type="layernorm", use_bias=False,
    n_experts=16, top_k=2,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi35-moe-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
        n_experts=4, top_k=2)
