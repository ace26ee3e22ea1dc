"""Assigned input-shape sets and input specs (counterpart of
``repro.launch.shapes``).

Every (architecture x shape) cell is defined here; ``input_specs`` returns
stand-ins with the JAX package's shapes and dtypes as tensors on the
``meta`` device (no allocation), and ``make_batch`` materializes small real
batches for smoke tests, drawn as the JAX package draws them (a seed gives
both packages the same batch).

``decode_*`` / ``long_*`` shapes stand for ``serve_step`` (one new token
against a seq_len KV cache); ``long_500k`` requires sub-quadratic attention
and runs only for the hybrid/SSM architectures (full-attention archs record
a documented skip).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig

__all__ = ["SHAPES", "SUBQUADRATIC", "Shape", "cell_supported",
           "decode_input_specs", "input_specs", "make_batch",
           "prefill_input_specs", "train_input_specs"]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# long_500k only for sub-quadratic sequence mixing
SUBQUADRATIC = {"hybrid", "ssm"}


def cell_supported(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, "full quadratic attention: 500k decode infeasible"
    return True, ""


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len - cfg.n_image_tokens if cfg.n_image_tokens else seq_len


def _conditioning(cfg: ModelConfig, b: int) -> dict:
    spec = {}
    if cfg.is_encdec:
        spec["frames"] = _spec((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
    if cfg.n_image_tokens:
        spec["image_embeds"] = _spec((b, cfg.n_image_tokens, cfg.d_model),
                                     torch.bfloat16)
    return spec


def train_input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    b, s = shape.global_batch, _text_len(cfg, shape.seq_len)
    return {"tokens": _spec((b, s), torch.int32),
            "targets": _spec((b, s), torch.int32),
            "loss_mask": _spec((b, s), torch.float32),
            **_conditioning(cfg, b)}


def prefill_input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    b, s = shape.global_batch, _text_len(cfg, shape.seq_len)
    return {"tokens": _spec((b, s), torch.int32), **_conditioning(cfg, b)}


def decode_input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    b = shape.global_batch
    return {
        "cache": lm.init_cache(cfg, b, shape.seq_len, dtype=torch.bfloat16,
                               device="meta"),
        "tokens": _spec((b, 1), torch.int32),
        "pos": _spec((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


# ---------------------------------------------------------------------------
# real (small) batches for smoke tests / examples
# ---------------------------------------------------------------------------

def make_batch(cfg: ModelConfig, *, batch: int, seq: int, seed: int = 0):
    """Tokens, targets, a ones loss mask, and frames or image embeddings
    rounded to bf16, from ``np.random.default_rng(seed)`` in the JAX
    package's order; CPU tensors."""
    rng = np.random.default_rng(seed)
    s = seq
    out = {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, s)).astype(np.int32)),
        "targets": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, s)).astype(np.int32)),
        "loss_mask": torch.ones((batch, s), dtype=torch.float32),
    }
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_frames, cfg.d_model))).to(torch.bfloat16)
    if cfg.n_image_tokens:
        out["image_embeds"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model))).to(torch.bfloat16)
    return out
