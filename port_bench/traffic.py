"""The general generator of training traffic.

A traffic file (``traffic/<name>.json``) gives the batch, the sequence
length and the token draw; batch ``index`` of a run is a pure function of
(``--seed``, ``index``), so the same seed gives the same batches.  The draw
is copied from ``src/repro_torch/data/pipeline.py`` (commit 93b320d,
``SyntheticTokenPipeline._tokens`` and ``batch_at``): Zipf(a) ids modulo the
vocabulary, ``seq_len + 1`` a row, split into tokens and next-token
targets, every position counted in the loss.
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_at", "tokens_per_step", "SEED_MASK"]

#: ``--seed`` is any whole number; its low 63 bits seed the draws
SEED_MASK = (1 << 63) - 1


def tokens_per_step(traffic: dict) -> int:
    return int(traffic["batch"]) * int(traffic["seq_len"])


def batch_at(traffic: dict, vocab: int, seed: int, index: int) -> dict:
    """Host batch ``index``: ``tokens`` and ``targets`` (B, S) int32,
    ``loss_mask`` (B, S) float32."""
    tok = traffic["tokens"]
    if tok["draw"] != "zipf":
        raise ValueError(f"unknown token draw {tok['draw']!r}")
    b, s = int(traffic["batch"]), int(traffic["seq_len"])
    rng = np.random.default_rng((seed & SEED_MASK, int(index)))
    raw = (rng.zipf(float(tok["a"]), size=(b, s + 1)) % vocab).astype(
        np.int32)
    if traffic.get("loss_mask", "full") != "full":
        raise ValueError(f"unknown loss mask {traffic['loss_mask']!r}")
    return {"tokens": raw[:, :-1], "targets": raw[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}
