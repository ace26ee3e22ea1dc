"""whisper-small [arXiv:2212.04356]: enc-dec (12+12 layers), GELU MLP,
LayerNorm with bias; the conv audio frontend is a STUB -- ``input_specs``
supplies precomputed frame embeddings (1500 frames)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    block_type="llama", norm_type="layernorm", mlp_type="gelu",
    use_bias=True, encoder_layers=12, n_frames=1500,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        encoder_layers=2, n_frames=32, max_decode_len=128)
