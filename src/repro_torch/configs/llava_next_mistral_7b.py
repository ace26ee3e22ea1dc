"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
Mistral-7B backbone; anyres vision frontend is a STUB -- ``input_specs``
supplies precomputed patch embeddings (576 base-resolution tokens)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    block_type="llama", norm_type="rmsnorm", rope_theta=1_000_000.0,
    n_image_tokens=576,
)


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-tiny", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        n_image_tokens=8)
