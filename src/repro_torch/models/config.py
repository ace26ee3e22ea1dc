"""Model configuration covering all 10 assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # block wiring
    block_type: str = "llama"   # llama | parallel (cohere)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp_type: str = "swiglu"    # swiglu | gelu (whisper)
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid (RecurrentGemma): blocks cycle [recurrent]*rec_per_attn + [attn]
    rglru: bool = False
    rec_per_attn: int = 2
    window: int = 0             # local-attention window (0 = full)
    conv_width: int = 4
    lru_width: int = 0          # 0 -> d_model

    # attention-free linear recurrence (RWKV-6 "Finch")
    rwkv: bool = False

    # encoder-decoder (Whisper): n_layers = decoder layers
    encoder_layers: int = 0
    n_frames: int = 1500        # audio frontend stub sequence length
    max_decode_len: int = 32768  # learned decoder position table size

    # VLM (LLaVA-NeXT): precomputed patch embeddings prepended to text
    n_image_tokens: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rglru and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.n_heads and not self.rwkv:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
                "q heads must be divisible by kv heads (GQA)"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd if not self.rwkv else 0
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.rwkv:
            # time-mix (r,k,v,g,o + decay LoRA) + channel-mix
            attn = 5 * d * d
            mlp = 3 * d * ff
        elif self.is_moe:
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts
        else:
            mlp = 3 * d * ff
        per_layer = attn + mlp + 2 * d
        total = self.n_layers * per_layer
        if self.rglru:
            w = self.lru_width
            rec_block = d * w * 2 + w * self.conv_width + 3 * w + w * d + 3 * d * ff
            n_attn = self.n_layers // (self.rec_per_attn + 1)
            n_rec = self.n_layers - n_attn
            total = n_rec * rec_block + n_attn * per_layer
        if self.is_encdec:
            enc = self.encoder_layers * (attn + 3 * d * ff + 2 * d)
            dec_cross = self.n_layers * (d * n_q + 2 * d * n_kv + n_q * d)
            total += enc + dec_cross
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * ff
        return int(dense + self.n_layers * self.top_k * 3 * d * ff)
