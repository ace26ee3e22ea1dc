"""Deterministic, shardable, resumable synthetic-token pipeline.

A copy of ``repro.data.pipeline`` (numpy only): batch ``i`` is the same
bytes in both packages.

Design goals mirrored from production data loaders:

* **Deterministic**: batch ``i`` is a pure function of (seed, i) -- any host
  can regenerate any shard, which is what makes CRCH-style *speculative
  shard replication* (``ft/straggler.py``) free of coordination: two hosts
  computing the same shard produce identical tokens.
* **Shardable**: ``shard(host, n_hosts)`` views are disjoint slices of the
  global batch.
* **Resumable**: the full iterator state is one integer (``next_index``),
  stored in the checkpoint global index -- the paper's "light-weight program
  state".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticTokenPipeline"]


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


class SyntheticTokenPipeline:
    """Zipf-ish synthetic LM batches with next-token targets."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig, *,
                 start_index: int = 0):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.next_index = int(start_index)

    # -- state (checkpointable) ---------------------------------------------
    def state(self) -> dict:
        return {"next_index": self.next_index, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, model_cfg: ModelConfig,
                   state: dict) -> "SyntheticTokenPipeline":
        assert state["seed"] == cfg.seed, "seed mismatch on restore"
        return cls(cfg, model_cfg, start_index=state["next_index"])

    # -- batch generation ----------------------------------------------------
    def _tokens(self, index: int, rows: slice) -> np.ndarray:
        b = self.cfg.global_batch
        s = self.cfg.seq_len
        v = self.model_cfg.vocab_size
        rng = np.random.default_rng((self.cfg.seed, index))
        # Zipf-like marginal with a deterministic per-row offset pattern
        raw = rng.zipf(1.3, size=(b, s + 1)) % v
        return raw.astype(np.int32)[rows]

    def batch_at(self, index: int, *, host: int = 0, n_hosts: int = 1) -> dict:
        b = self.cfg.global_batch
        assert b % n_hosts == 0
        rows = slice(host * b // n_hosts, (host + 1) * b // n_hosts)
        tok = self._tokens(index, rows)
        out = {
            "tokens": tok[:, :-1],
            "targets": tok[:, 1:],
            "loss_mask": np.ones((tok.shape[0], tok.shape[1] - 1),
                                 np.float32),
        }
        mc = self.model_cfg
        rng = np.random.default_rng((self.cfg.seed, index, 7))
        if mc.is_encdec:
            out["frames"] = rng.standard_normal(
                (tok.shape[0], mc.n_frames, mc.d_model)).astype(np.float32)
        if mc.n_image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (tok.shape[0], mc.n_image_tokens, mc.d_model)
            ).astype(np.float32)
        return out

    def __next__(self) -> dict:
        batch = self.batch_at(self.next_index)
        self.next_index += 1
        return batch

    def __iter__(self):
        return self
