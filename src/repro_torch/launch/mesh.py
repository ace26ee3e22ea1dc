"""Mesh construction on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

Defined as functions, so importing this module starts no process group.
:func:`make_debug_mesh` builds a one-rank mesh on the caller's device,
starting a world-size-1 group (NCCL on CUDA, gloo on the CPU) on an
in-process ``HashStore`` when none exists.  :func:`make_production_mesh`
gives the 256-rank ``(16, 16)`` ``("data", "model")`` mesh or the 512-rank
``(2, 16, 16)`` ``("pod", "data", "model")`` one; it needs that many ranks,
which the dry run has under its fake process group
(:func:`init_fake_group`: backend ``"fake"`` on a ``FakeStore``, every
rank's collectives shape-only, in one process).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["destroy_group", "init_fake_group", "make_debug_mesh",
           "make_production_mesh", "mesh_from_flag"]


#: whether this module started the current process group
_started = [False]


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), device="cpu"):
    """A ``DeviceMesh`` of ``shape`` on ``device``'s type, over the current
    process group; without one, a world-size-1 group (NCCL on CUDA, gloo on
    the CPU) on an in-process ``HashStore`` is started first
    (:func:`destroy_group` ends it)."""
    device = torch.device(device)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(f"mesh {tuple(shape)} needs a process group "
                               f"of {math.prod(shape)} ranks")
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
        _started[0] = True
    return _mesh(device.type, shape, axes)


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (rank
    0): collectives check shapes and move no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    _started[0] = True


def destroy_group() -> None:
    """End the process group this module started, if any (a caller's own
    group is left alone)."""
    if _started[0] and dist.is_initialized():
        dist.destroy_process_group()
    _started[0] = False


def make_production_mesh(*, multi_pod: bool = False, device="cpu"):
    """(16, 16) ``("data", "model")``: 256 ranks; (2, 16, 16) ``("pod",
    "data", "model")``: 512 ranks, two pods of 256."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {have}; run under "
            f"a fake process group of {need} ranks (init_fake_group) for "
            f"the dry-run")
    return _mesh(torch.device(device).type, shape, axes)


def mesh_from_flag(kind: str | None, device="cpu"):
    """The launchers' ``--mesh``: None (no flag) -> no mesh; ``debug`` ->
    :func:`make_debug_mesh` on ``device``; ``single`` / ``multi`` ->
    :func:`make_production_mesh` (a process group of 256 / 512 ranks
    must exist)."""
    if kind is None:
        return None
    if kind == "debug":
        return make_debug_mesh(device=device)
    return make_production_mesh(multi_pod=(kind == "multi"), device=device)
