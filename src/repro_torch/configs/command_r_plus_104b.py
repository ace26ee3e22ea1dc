"""command-r-plus-104b [hf:CohereForAI]: parallel attn+FFN block, GQA kv=8,
LayerNorm without bias, tied embeddings, no-bias projections."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256_000,
    block_type="parallel", norm_type="layernorm", use_bias=False,
    tie_embeddings=True, rope_theta=75_000.0,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="command-r-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=512)
