"""Lightweight synchronized decode-state checkpoints (paper Eq. 10 online).

Counterpart of ``repro.serve.snapshot``.  A *decode snapshot* copies one
slot's KV-cache row + decode position + emitted tokens to host memory every
``lambda`` generated tokens; when the worker holding the slot fails, the
request resumes from its last snapshot on any free slot.

The slot helpers work on cache dicts of tensors.  The per-leaf batch axis is
found by building ``lm.init_cache`` on the ``meta`` device at batch sizes 2
and 3 (no allocation), so the same code handles the dense (L, B, S, KV, D),
RWKV (L, B, ...) and hybrid (n_super, rec_per_attn, B, ...) layouts.  Rows go to the host as CPU tensors; since numpy has
no bf16, the checksum hashes each leaf's raw bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig

__all__ = [
    "cache_batch_axes",
    "slot_get",
    "slot_set",
    "DecodeSnapshot",
    "SnapshotStore",
    "snapshot_digest",
]


def cache_batch_axes(cfg: ModelConfig, cache_len: int) -> dict[str, int]:
    """Leaf name -> batch axis: the single axis whose extent changes
    between batch sizes 2 and 3."""
    a2 = lm.init_cache(cfg, 2, cache_len, device="meta")
    a3 = lm.init_cache(cfg, 3, cache_len, device="meta")

    def axis(l2, l3):
        diffs = [i for i, (x, y) in enumerate(zip(l2.shape, l3.shape))
                 if x != y]
        if len(diffs) != 1:
            raise ValueError(
                f"ambiguous batch axis for cache leaf {tuple(l2.shape)}")
        return diffs[0]

    return {name: axis(a2[name], a3[name]) for name in a2}


def slot_get(cache, axes, slot: int) -> dict[str, torch.Tensor]:
    """A host copy of one batch row (slot) of every cache leaf."""
    return {name: leaf.select(axes[name], slot).to("cpu", copy=True)
            for name, leaf in cache.items()}


def slot_set(cache, axes, slot: int, row) -> dict[str, torch.Tensor]:
    """Write a single-slot row back into the batched cache, in place, cast
    to the cache's dtype."""
    for name, leaf in cache.items():
        leaf.select(axes[name], slot).copy_(row[name])
    return cache


def _raw(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


@dataclasses.dataclass
class DecodeSnapshot:
    """Host-side resumable decode state of one request."""

    rid: int
    pos: int                    # absolute position of the next decode write
    tokens: list[int]           # tokens emitted up to the snapshot
    last_token: int
    cache_row: dict             # leaf name -> single-slot CPU tensor
    step: int                   # engine step at which it was taken
    checksum: str = ""          # content hash set by SnapshotStore.save

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in self.cache_row.values()))


def snapshot_digest(snap: DecodeSnapshot) -> str:
    """Content hash over decode registers + tokens + every cache-row leaf
    (in sorted leaf-name order, as a JAX pytree of a dict)."""
    h = hashlib.sha1()
    h.update(np.asarray([snap.rid, snap.pos, snap.last_token],
                        np.int64).tobytes())
    h.update(np.asarray(snap.tokens, np.int64).tobytes())
    for name in sorted(snap.cache_row):
        h.update(_raw(snap.cache_row[name]))
    return h.hexdigest()


class SnapshotStore:
    """Latest-snapshot-per-request store (the paper keeps only the newest
    synchronized checkpoint; older ones are superseded)."""

    def __init__(self) -> None:
        self._by_rid: dict[int, DecodeSnapshot] = {}
        self.saved = 0
        self.bytes_written = 0
        self.corrupted = 0

    def save(self, snap: DecodeSnapshot) -> None:
        snap.checksum = snapshot_digest(snap)
        self._by_rid[snap.rid] = snap
        self.saved += 1
        self.bytes_written += snap.nbytes()

    def get(self, rid: int) -> DecodeSnapshot | None:
        return self._by_rid.get(rid)

    def drop(self, rid: int) -> None:
        self._by_rid.pop(rid, None)

    def verify(self, snap: DecodeSnapshot) -> bool:
        """True iff the snapshot's content still matches its checksum
        (snapshots without one — hand-built — are trusted)."""
        return not snap.checksum or snap.checksum == snapshot_digest(snap)

    def corrupt(self, seed: int) -> int:
        """Chaos ``snapshot_corrupt``: flip one byte in one stored snapshot.

        Victim snapshot/leaf/byte are pure functions of ``seed`` so a trace
        replay corrupts the exact same state.  Returns 0 when no snapshot
        (or no non-empty leaf) exists, else 1.
        """
        if not self._by_rid:
            return 0
        rids = sorted(self._by_rid)
        snap = self._by_rid[rids[seed % len(rids)]]
        names = [n for n in sorted(snap.cache_row)
                 if snap.cache_row[n].numel()]
        if not names:
            return 0
        name = names[seed % len(names)]
        leaf = snap.cache_row[name]
        raw = bytearray(_raw(leaf))
        raw[seed % len(raw)] ^= 0xFF
        snap.cache_row = dict(snap.cache_row)
        snap.cache_row[name] = (torch.frombuffer(raw, dtype=torch.uint8)
                                .view(leaf.dtype).reshape(leaf.shape).clone())
        self.corrupted += 1
        return 1

    def __len__(self) -> int:
        return len(self._by_rid)
