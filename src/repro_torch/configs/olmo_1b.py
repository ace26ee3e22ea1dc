"""olmo-1b [arXiv:2402.00838]: dense, non-parametric LayerNorm, MHA (kv=16),
tied embeddings, vocab padded to 50304."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50_304,
    block_type="llama", norm_type="nonparametric_ln", tie_embeddings=True,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="olmo-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
