"""Light-weight pointer-based distributed checkpointing.

The paper's checkpoint design (Section 3.1.3 / 4.1) adapted to training:

* every host dumps only *its own shards* to host-local stable storage
  (``store_dir/host_XX/step_N/leaf.npy``);
* a tiny **global index** (JSON) holds only *pointers* -- leaf path ->
  (host, file, content hash, shape, dtype) -- never tensor data;
* the commit is a single atomic rename of the index ("the pointer to the
  location on stable storage is stored in a global memory");
* restore is lazy per-shard and host-remappable, so an *elastic* restart on
  a different host count re-reads exactly the shards it needs;
* content hashes detect torn/corrupt writes (the paper invokes MESI for its
  shared counters; a content-addressed single-writer index needs no
  coherence protocol).

Robustness (the ``repro.chaos`` ``ckpt_corrupt`` recovery path):

* the store retains the last ``keep`` committed indices (older indices and
  their shard directories are pruned after each commit);
* ``restore`` walks committed indices newest -> oldest and returns the
  newest checkpoint whose shards *all* verify; a shard that fails its
  content hash (or is missing/unreadable) is **quarantined** — moved to
  ``store_dir/quarantine/`` with a JSON-logged reason — and the failed
  index is retired so later restores skip it.  Only when every committed
  checkpoint fails does ``restore`` raise.
* async-save failures are never silent: an exception raised inside the
  daemon ``_write`` thread is captured and re-raised from :meth:`wait`
  (and therefore from the next :meth:`save`/:meth:`restore`), instead of
  leaving a stale pointer with no signal.

Disk-full resilience (the ``repro.chaos`` ``disk_full`` recovery path):

* when a shard write raises ENOSPC mid-save (organically, or injected via
  :meth:`inject_disk_full`), the store deletes the half-written shards of
  the failed attempt, **prunes its oldest committed checkpoint** (index
  first, then shards) to free space, and retries the save;
* only when no committed history is left to prune does the error propagate;
* the committed index can never be corrupted by this path: the pointer flip
  is a single atomic rename that only happens after every shard of the
  attempt has been written, and :meth:`verify_committed` can audit that
  every committed index still points at verifying shards.

Async mode overlaps serialization with compute and only the pointer flip is
synchronous -- the training analogue of "synchronized light-weight
checkpoints".

Port notes (counterpart of ``repro.ft.checkpoint``): the trees are nested
dicts of tensors (or numpy arrays), flattened with JAX's order and names
(:mod:`repro_torch.tree`), and the files, hashes and index are byte for
byte the JAX store's, so a checkpoint written by either package restores in
the other.  Every leaf is copied to host numpy **before** an async write
starts: torch tensors are mutable, and a writer thread reading live device
memory could mix two steps and still pass its own sha1, computed from the
same torn bytes.  ``restore`` puts each leaf on the device of the matching
leaf of ``like_tree``.  A synchronous save writes and hashes its leaves, and
a restore or an audit reads and hashes them, a leaf a thread (``np.save``,
``np.load`` and sha1 release the interpreter lock): the caller waits on
them.  An async save keeps to its one writer thread, so that the steps it
overlaps keep the host's other cores.  What each leaf gives is taken in
leaf order, so the files, the index and the first failure reported are
the one-thread ones.
"""
from __future__ import annotations

import concurrent.futures
import errno
import glob
import hashlib
import json
import logging
import os
import shutil
import threading

import numpy as np
import torch

from ..distributed.sharding import is_dtensor
from ..obs import trace
from ..obs.trace import NULL_TRACER
from ..tree import flatten, leaf_name, unflatten

__all__ = ["CheckpointStore"]

log = logging.getLogger(__name__)


def _leaf_paths(tree):
    return [(leaf_name(path), leaf) for path, leaf in flatten(tree)]


def _to_host(leaf) -> np.ndarray:
    """A host numpy copy of one leaf: a device tensor's copy to the host is
    already one; a host tensor or array is copied.  A DTensor is read
    whole (``full_tensor``), so a sharded run writes what an unsharded
    one does."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr if leaf.device.type != "cpu" else arr.copy()
    return np.array(leaf)


def _sha1(arr: np.ndarray) -> str:
    """The sha1 of ``arr.tobytes()`` (the JAX store's hash), read in place
    rather than from a copy of the bytes."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha1(flat).hexdigest()


#: threads a save, a restore or an audit spreads its leaves over
_IO_THREADS = min(8, os.cpu_count() or 1)


def _map(fn, items, threads: int = _IO_THREADS) -> list:
    """``[fn(x) for x in items]`` over up to ``threads`` threads; the first
    exception in item order is raised once every call has ended."""
    items = list(items)
    if threads < 2 or len(items) < 2:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(
            min(threads, len(items))) as pool:
        return list(pool.map(fn, items))


def _caught(fn, exc=Exception):
    """``fn`` returning ``(result, None)``, or ``(None, e)`` for an ``exc``
    it raised, so that each item's outcome can be taken in order."""
    def call(x):
        try:
            return fn(x), None
        except exc as e:
            return None, e
    return call


def _like(arr: np.ndarray, like):
    """``arr`` as ``like``'s kind: a tensor on ``like``'s device (a DTensor
    at ``like``'s placements, each rank keeping its shard), or numpy."""
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(torch.from_numpy(arr).to(like.device),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


class CheckpointStore:
    """File-backed pointer checkpoint store with fallback restore."""

    def __init__(self, root: str, *, n_hosts: int = 1, keep: int = 3,
                 tracer=None):
        self.root = root
        self.n_hosts = n_hosts
        self.keep = max(1, int(keep))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        os.makedirs(root, exist_ok=True)
        self._async_thread: threading.Thread | None = None
        self._async_exc: BaseException | None = None
        self.quarantined: list[dict] = []
        # committed indices skipped during the most recent restore()
        self.last_restore_fallbacks = 0
        # disk-full path: armed ENOSPC injections + recovery counters
        self._enospc_armed = 0
        self.enospc_retries = 0
        self.pruned_for_space: list[int] = []

    # -- paths ---------------------------------------------------------------
    def _index_path(self, step: int) -> str:
        return os.path.join(self.root, f"index_{step:09d}.json")

    def _host_dir(self, host: int, step: int) -> str:
        d = os.path.join(self.root, f"host_{host:03d}", f"step_{step:09d}")
        os.makedirs(d, exist_ok=True)
        return d

    def _quarantine_dir(self) -> str:
        d = os.path.join(self.root, "quarantine")
        os.makedirs(d, exist_ok=True)
        return d

    # -- committed-index bookkeeping -----------------------------------------
    def _list_committed(self) -> list[int]:
        steps = []
        for f in os.listdir(self.root):
            if f.startswith("index_") and f.endswith(".json"):
                try:
                    steps.append(int(f[len("index_"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(steps)

    def committed_steps(self) -> list[int]:
        """Steps with a committed index, oldest first."""
        self.wait()
        return self._list_committed()

    def read_index(self, step: int) -> dict:
        with open(self._index_path(step)) as f:
            return json.load(f)

    def _prune(self) -> None:
        # index first: a crash mid-prune must never leave an index pointing
        # at deleted shards
        for step in self._list_committed()[:-self.keep]:
            try:
                os.remove(self._index_path(step))
            except OSError:
                pass
            for d in glob.glob(os.path.join(
                    self.root, "host_*", f"step_{step:09d}")):
                shutil.rmtree(d, ignore_errors=True)

    # -- disk-full (ENOSPC) handling ------------------------------------------
    def inject_disk_full(self, count: int = 1) -> None:
        """Arm the next ``count`` shard-write attempts to raise ENOSPC
        mid-save (the ``repro.chaos`` ``disk_full`` fault)."""
        self._enospc_armed += max(0, int(count))

    def _drop_step_files(self, step: int) -> None:
        """Delete the (possibly half-written) shards of an uncommitted
        attempt; never touches the committed index."""
        for d in glob.glob(os.path.join(
                self.root, "host_*", f"step_{step:09d}")):
            shutil.rmtree(d, ignore_errors=True)

    def _prune_oldest_for_space(self, protect: int) -> bool:
        """Free space by retiring the oldest committed checkpoint (index
        first, then shards).  ``protect`` is the step being written — its
        predecessor history is fair game, the in-flight step is not."""
        candidates = [s for s in self._list_committed() if s != protect]
        if not candidates:
            return False
        victim = candidates[0]
        try:
            os.remove(self._index_path(victim))
        except OSError:
            pass
        self._drop_step_files(victim)
        self.pruned_for_space.append(victim)
        self.tracer.event("ckpt.prune", step=victim, reason="disk_full")
        log.warning("checkpoint step %d pruned to free disk space", victim)
        return True

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             sync: bool = True) -> dict:
        """Write shards + commit the pointer index.  ``tree`` is a nested
        dict of tensors or arrays; leaves are round-robined across hosts (stand-in for "each
        host writes its local shards").

        A shard write that raises ENOSPC aborts the attempt *before* the
        pointer flip: the half-written shards are deleted, the oldest
        committed checkpoint is pruned to free space, and the save retries.
        The error propagates only when no committed history remains to
        prune, and the committed index is consistent either way."""
        self.wait()
        leaves: list = []

        def _copy_to_host() -> None:
            # host copies, before any writer thread starts (see above); the
            # ckpt.save span includes them
            leaves.extend((name, _to_host(leaf))
                          for name, leaf in _leaf_paths(tree))

        def _path(i: int, name: str) -> str:
            fname = hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"
            return os.path.join(self._host_dir(i % self.n_hosts, step), fname)

        def _write_leaf(item) -> dict:
            i, (name, arr) = item
            fpath = _path(i, name)
            with open(fpath, "wb") as f:
                np.save(f, arr)
            return {"host": i % self.n_hosts, "file": fpath,
                    "sha1": _sha1(arr), "shape": list(arr.shape),
                    "dtype": str(arr.dtype)}

        def _write_once(threads: int) -> dict:
            # an armed injection strikes at the middle leaf, once the
            # leaves before it are written
            cut = len(leaves) // 2 if self._enospc_armed else len(leaves)
            metas = _map(_write_leaf, enumerate(leaves[:cut]), threads)
            if cut < len(leaves):
                self._enospc_armed -= 1
                raise OSError(errno.ENOSPC,
                              "No space left on device (injected)",
                              _path(cut, leaves[cut][0]))
            index = {"step": step, "extra": extra or {},
                     "leaves": {name: meta for (name, _), meta
                                in zip(leaves, metas)}}
            tmp = self._index_path(step) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(index, f)
            os.replace(tmp, self._index_path(step))   # atomic pointer flip
            self._prune()
            return index

        def _write(threads: int) -> dict:
            while True:
                try:
                    return _write_once(threads)
                except OSError as e:
                    if e.errno != errno.ENOSPC:
                        raise
                    self._drop_step_files(step)
                    if not self._prune_oldest_for_space(step):
                        raise
                    self.enospc_retries += 1
                    self.tracer.event("ckpt.enospc_retry", step=step)
                    log.warning("checkpoint save step %d hit ENOSPC; "
                                "pruned oldest commit and retrying", step)

        if sync:
            with self.tracer.span("ckpt.save", track="ckpt-io", step=step,
                                  mode="sync"):
                _copy_to_host()
                return _write(_IO_THREADS)

        t_start = self.tracer.clock()
        _copy_to_host()

        def _runner() -> None:
            try:
                # on this thread's own profiler timeline (the recorder gets
                # the span below)
                with trace.range("ckpt.save"):
                    _write(1)
                # complete() is thread-safe (bypasses the span stack), so
                # the writer thread can report its own wall time
                self.tracer.complete("ckpt.save", t_start,
                                     self.tracer.clock(), track="ckpt-io",
                                     step=step, mode="async")
            except BaseException as e:   # surfaced from wait(), not lost
                self._async_exc = e

        self._async_thread = threading.Thread(target=_runner, daemon=True)
        self._async_thread.start()
        return {"step": step, "async": True}

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def _quarantine(self, path: str, reason: str, step: int) -> None:
        qdir = self._quarantine_dir()
        dest = os.path.join(qdir, f"step_{step:09d}__{os.path.basename(path)}")
        try:
            os.replace(path, dest)
        except OSError:
            dest = None
        rec = {"step": step, "path": path, "quarantined_to": dest,
               "reason": reason}
        self.quarantined.append(rec)
        self.tracer.event("ckpt.quarantine", step=step, reason=reason)
        with open(os.path.join(qdir, "LOG.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        log.warning("checkpoint shard quarantined: %s (%s)", path, reason)

    def _read_verified(self, step: int, leaves, verify: bool):
        index = self.read_index(step)

        def _read(name: str):
            meta = index["leaves"].get(name)
            if meta is None:
                raise IOError(f"leaf {name} missing from index step {step}")
            with open(meta["file"], "rb") as f:
                arr = np.load(f)
            return arr, meta, _sha1(arr) if verify else None

        out = []
        for (name, _), (got, err) in zip(
                leaves, _map(_caught(_read), (name for name, _ in leaves))):
            if err is not None:
                raise err
            arr, meta, digest = got
            if verify and digest != meta["sha1"]:
                self._quarantine(meta["file"],
                                 f"checksum mismatch for leaf {name}", step)
                raise IOError(f"checksum mismatch for {name} "
                              f"({meta['file']})")
            out.append(arr)
        return out, index

    def restore(self, like_tree, *, verify: bool = True):
        """Restore into the structure of ``like_tree`` (lazy per-leaf reads).

        Walks committed checkpoints newest -> oldest and returns the newest
        one whose shards all verify, quarantining bad shards and retiring
        failed indices along the way.  Raises only when *no* committed
        checkpoint passes.  Returns (tree, step, extra).
        """
        self.wait()
        leaves = _leaf_paths(like_tree)
        steps = self.committed_steps()
        if not steps:
            raise FileNotFoundError(
                f"no committed checkpoint index under {self.root}")
        self.last_restore_fallbacks = 0
        errors: list[str] = []
        with self.tracer.span("ckpt.restore", track="ckpt-io",
                              newest=steps[-1]) as sp:
            for step in reversed(steps):
                try:
                    out, index = self._read_verified(step, leaves, verify)
                except Exception as e:   # corrupt/missing shard: fall back
                    errors.append(f"step {step}: {e}")
                    self.last_restore_fallbacks += 1
                    self.tracer.event("ckpt.fallback", step=step,
                                      reason=str(e)[:120])
                    # retire the failed index so later restores skip it
                    try:
                        os.replace(self._index_path(step), os.path.join(
                            self._quarantine_dir(), f"index_{step:09d}.json"))
                    except OSError:
                        pass
                    log.warning("checkpoint step %d failed verification "
                                "(%s); falling back", step, e)
                    continue
                if errors:
                    log.warning("restore fell back to step %d after %d bad "
                                "checkpoint(s)", step, len(errors))
                    self.tracer.recovery("ckpt_corrupt", restored_step=step,
                                         fallbacks=len(errors))
                sp.set(restored_step=step,
                       fallbacks=self.last_restore_fallbacks)
                tree = unflatten(like_tree, [_like(arr, like) for arr, (_, like)
                                             in zip(out, leaves)])
                return tree, index["step"], index["extra"]
        raise IOError(
            f"no committed checkpoint passed verification under {self.root} "
            f"(bad shards quarantined to {self._quarantine_dir()}): "
            + "; ".join(errors))

    def verify_committed(self) -> list[str]:
        """Audit every committed index: each must parse and every shard it
        points at must exist and match its content hash.  Returns the list
        of violations (empty = the committed index is fully consistent) —
        the ``disk_full`` invariant check."""
        problems: list[str] = []
        for step in self.committed_steps():
            try:
                index = self.read_index(step)
            except (OSError, ValueError) as e:
                problems.append(f"step {step}: unreadable index ({e})")
                continue
            def _digest(meta) -> str:
                with open(meta["file"], "rb") as f:
                    return _sha1(np.load(f))

            shards = sorted(index["leaves"].items())
            for (name, meta), (digest, err) in zip(shards, _map(
                    _caught(_digest, OSError), (m for _, m in shards))):
                if err is not None:
                    problems.append(f"step {step}: shard {name} missing "
                                    f"({err})")
                elif digest != meta["sha1"]:
                    problems.append(
                        f"step {step}: shard {name} checksum mismatch")
        return problems
