"""Prefill and serve step factories (counterparts of ``repro.distributed.steps``).

PyTorch runs eagerly, so a factory returns a plain closure over the model
functions; there is nothing to compile, and the optional inputs that JAX
fixes at trace time are optional arguments here.  ``make_train_step``
waits for the training slice.
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step"]


def make_serve_step(cfg: ModelConfig, *, cache_axes=None):
    """One greedy decode step: (params, cache, tokens (B,1), pos, live=None)
    -> (next_tokens (B,1) int32, logits fp32, cache).  ``pos`` may be a
    Python int (static batch) or a (B,) tensor (continuous batching).

    A ``live`` (B,) bool argument commits cache writes for live rows only.
    The commit is made **in place**: the decode writes the new K/V entry or
    recurrent state of each live row into the cache along that leaf's batch
    axis and never touches an idle row, so a freed slot keeps its previous
    row bit-identical (JAX computes every row and selects with ``where``;
    the result is the same).  ``cache_axes`` (the per-leaf batch axes from
    ``repro_torch.serve.snapshot.cache_batch_axes``) is checked against the
    axes that commit writes (``lm.commit_axes``)."""
    if cache_axes is not None and dict(cache_axes) != lm.commit_axes(cfg):
        raise ValueError(f"the in-place commit writes batch axes "
                         f"{lm.commit_axes(cfg)}; the cache has {cache_axes}")

    def serve_step(params, cache, tokens, pos, live=None):
        logits, cache = lm.decode_step(params, cfg, cache, tokens, pos,
                                       live=live)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(params, batch, last_idx=None)``; ``last_idx`` (B,)
    picks each row's true last prompt position (bucket-padded prompts, see
    ``lm.prefill``)."""

    def prefill_step(params, batch, last_idx=None):
        return lm.prefill(params, cfg, batch, cache_len, last_idx=last_idx)

    return prefill_step
