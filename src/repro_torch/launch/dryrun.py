"""Dry run of every (architecture x shape) cell on the production meshes
(counterpart of ``repro.launch.dryrun``).

Each cell's train, prefill or decode step runs once, eagerly, under a fake
process group of 256 (``single``: (16, 16) ``("data", "model")``) or 512
ranks (``multi``: (2, 16, 16) ``("pod", "data", "model")``) and
``FakeTensorMode``: the params, optimizer state, batch and cache are
DTensors laid out by ``distributed.params`` whose shards are fake tensors
of rank 0's local shapes, so nothing is allocated and no kernel runs (the
hand-written kernels' wrappers return their outputs' shapes and report
their work).  One JSON row a cell goes under ``build/dryrun/``:

* ``memory``: ``argument_size_in_bytes`` (the local shard bytes of params,
  optimizer state and inputs), ``output_size_in_bytes``, and the peak of
  live bytes during the step (``peak_bytes``; ``temp_size_in_bytes`` is
  the peak above the arguments), all per rank;
* ``cost``: ``flops`` per rank: the local aten ops' FLOPs (PyTorch's flop
  formulas) and the kernels' own reports (``kernels._cost``), the latter
  also apart as ``kernel_flops`` / ``kernel_bytes``;
* ``collectives``: per-rank bytes and counts by kind of the collectives
  the step issued (``analysis.hlo``), and ``link_bytes``;
* ``lower_s``: the host seconds of the whole cell.

A dry-run figure is a layout on a fake mesh, not a time.  Where the
process sees a card, each row's peak is also held against its memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from ..analysis.hlo import CollectiveLog, collective_totals, link_bytes
from ..configs import ARCHS, get_config
from ..distributed import params as pshard
from ..distributed.sharding import (dtensor_zeros, mesh_extents,
                                    spec_to_placements, use_rules)
from ..distributed.steps import (make_prefill_step, make_serve_step,
                                 make_train_step)
from ..kernels import _cost
from ..models import lm
from ..tree import flatten, tree_map, unflatten
from . import shapes as shp
from .mesh import destroy_group, init_fake_group, make_production_mesh

__all__ = ["ACCUM", "MESHES", "OUT_DIR", "SEQPAR", "ZERO1",
           "argument_bytes", "build_cell", "run_cell"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")

# grad-accumulation per architecture (train_4k): bounds activation memory
ACCUM = {
    "command_r_plus_104b": 8, "deepseek_coder_33b": 8, "granite_20b": 4,
    "phi35_moe_42b": 8, "llava_next_mistral_7b": 2,
    "rwkv6_3b": 2, "recurrentgemma_2b": 2, "olmo_1b": 1,
    "granite_moe_1b": 1, "whisper_small": 1,
}

# ZeRO-1 (bf16 params replicated over `data`, fp32 master+moments
# sharded); command-r-plus stays FSDP
ZERO1 = {
    "deepseek_coder_33b": True, "command_r_plus_104b": False,
    "olmo_1b": True, "granite_20b": True, "phi35_moe_42b": True,
    "granite_moe_1b": True, "recurrentgemma_2b": True,
    "llava_next_mistral_7b": True, "rwkv6_3b": True, "whisper_small": True,
}

# sequence-parallel residual stream between the blocks
SEQPAR = {
    "command_r_plus_104b": True, "deepseek_coder_33b": True,
    "phi35_moe_42b": True, "llava_next_mistral_7b": True,
    "granite_20b": True, "granite_moe_1b": True,
    "recurrentgemma_2b": True, "rwkv6_3b": True,
    "olmo_1b": False, "whisper_small": False,
}

#: mesh kind -> (shape, axis names)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _cfg(arch: str):
    return dataclasses.replace(get_config(arch), param_dtype="bfloat16")


def _local_bytes(leaf, spec, mesh) -> int:
    """Bytes of one rank's shard of ``leaf`` under ``spec`` (the specs
    divide every dimension they shard)."""
    ext = mesh_extents(mesh)
    n = leaf.numel()
    for part in spec:
        for a in (() if part is None else
                  part if isinstance(part, tuple) else (part,)):
            n //= ext[a]
    return n * leaf.element_size()


def _abstract_args(cfg, shape, mesh, zero1: bool):
    """The cell's step inputs as meta tensors with their specs:
    [(name, tree, specs)]; the optimizer's step and the decode position
    are host ints (JAX's 0-d int32s, counted as 4 bytes each)."""
    params = lm.abstract_params(cfg)
    out = [("params", params, pshard.param_specs(params, mesh, zero1=zero1))]
    specs = shp.input_specs(cfg, shape)
    if shape.kind == "train":
        f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"), params)
        opt = {"mu": f32, "nu": f32, "master": f32}
        ospec = pshard.opt_state_specs(opt, params, mesh, zero1=zero1)
        out.append(("opt", opt, {k: ospec[k] for k in opt}))
        out.append(("batch", specs, pshard.batch_specs(specs, mesh)))
    elif shape.kind == "prefill":
        out.append(("batch", specs, pshard.batch_specs(specs, mesh)))
    else:
        out.append(("cache", specs["cache"],
                    pshard.cache_specs(specs["cache"], cfg, mesh)))
        tok = {"tokens": specs["tokens"]}
        out.append(("tokens", tok, pshard.batch_specs(tok, mesh)))
    return out


def _module(arch: str) -> str:
    from ..configs import ALIASES
    return ALIASES.get(arch, arch)


def argument_bytes(arch: str, shape_name: str, mesh) -> int:
    """Per-rank argument bytes of a cell from the port's specs (``mesh`` a
    ``DeviceMesh`` or a ``MeshShape``): params, optimizer state (moments,
    master copy and the 4-byte step) and inputs for train; params and the
    batch for prefill; params, cache, tokens and the 4-byte position for
    decode."""
    cfg = _cfg(arch)
    shape = shp.SHAPES[shape_name]
    total = 4 if shape.kind in ("train", "decode") else 0
    zero1 = ZERO1.get(_module(arch), True)
    for _, tree, specs in _abstract_args(cfg, shape, mesh, zero1):
        total += sum(_local_bytes(leaf, spec, mesh) for (_, leaf), (_, spec)
                     in zip(flatten(tree), flatten(specs)))
    return total


def _fake_tree(tree, specs, mesh):
    """Zero DTensors of ``tree``'s shapes and dtypes under ``specs`` (a
    spec is a tuple: :func:`flatten` takes it as a leaf)."""
    return unflatten(tree, [
        dtensor_zeros(leaf.shape, leaf.dtype, mesh,
                      spec_to_placements(spec, mesh))
        for (_, leaf), (_, spec) in zip(flatten(tree), flatten(specs))])


class StepRecorder(CollectiveLog):
    """Per-rank FLOPs (PyTorch's formulas on the local ops), collectives,
    and the live bytes of the local storages (starting from ``base``
    bytes of arguments) with their peak."""

    def __init__(self, base: int = 0):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.by_op: dict[str, float] = {}
        self.live = self.peak = base
        self._seen: set[int] = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        nbytes = st.nbytes()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    def on_op(self, func, args, kwargs, out) -> None:
        super().on_op(func, args, kwargs, out)
        packet = func._overloadpacket
        if packet in self._flops:
            n = self._flops[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
        from torch.utils._pytree import tree_flatten
        for t in tree_flatten(out)[0]:
            # a meta tensor (a shape the code derives) holds no memory
            if (isinstance(t, torch.Tensor) and not t.is_sparse
                    and t.device.type != "meta"):
                self.track(t)


def build_cell(arch: str, shape_name: str, mesh):
    """Returns ``((step, args), None)`` for a supported cell, with the
    args fake DTensors on ``mesh`` (call inside ``FakeTensorMode``), or
    ``(None, reason)``."""
    cfg = _cfg(arch)
    shape = shp.SHAPES[shape_name]
    ok, why = shp.cell_supported(cfg, shape)
    if not ok:
        return None, why
    zero1 = ZERO1.get(_module(arch), True)
    args = {}
    for name, tree, specs in _abstract_args(cfg, shape, mesh, zero1):
        if name == "batch" and shape.kind == "train":
            # the global batch, as the launcher passes it: the step cuts
            # the microbatches and lays each out by batch_specs
            args[name] = tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)
        else:
            args[name] = _fake_tree(tree, specs, mesh)
    if shape.kind == "train":
        params = args["params"]
        grad_sh = (pshard.tree_placements(
            pshard.param_specs(params, mesh), mesh) if zero1 else None)
        step = make_train_step(cfg, accum_steps=ACCUM.get(_module(arch), 1),
                               grad_shardings=grad_sh)
        # the step counter is a host scalar that the schedule reads: a
        # Python int here, since a fake tensor has no value
        opt = dict(args["opt"], step=0)
        return (step, (params, opt, args["batch"])), None
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, cache_len=shape.seq_len)
        return (step, (args["params"], args["batch"])), None
    step = make_serve_step(cfg)
    return (step, (args["params"], args["cache"], args["tokens"]["tokens"],
                   shape.seq_len - 1)), None


@contextlib.contextmanager
def _real_index_math():
    """Run DTensor's shard index arithmetic (it builds ``arange`` tensors
    and reads them back) on real tensors while a fake mode is active: it
    is host bookkeeping, not the step's work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor.placement_types import _StridedShard
    sites = [(owner, name) for owner, name in (
        (_StridedShard, "local_shard_size_and_offset"),
        (_utils, "_compute_local_shape_and_global_offset"))
        if name in vars(owner)]
    saved = [vars(owner)[name] for owner, name in sites]

    def real(orig):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        return run

    for (owner, name), orig in zip(sites, saved):
        setattr(owner, name, real(orig))
    try:
        yield
    finally:
        for (owner, name), orig in zip(sites, saved):
            setattr(owner, name, orig)


def _mesh_for(kind: str):
    shape, _ = MESHES[kind]
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized() or dist.get_world_size() != need:
        destroy_group()
        init_fake_group(need)
    return make_production_mesh(multi_pod=(kind == "multi"))


def _local_tensor_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """One cell's row (JAX's ``run_cell`` layout without its compile time
    and HLO line count: eager PyTorch has neither)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    mesh = _mesh_for(mesh_kind)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": [[a, n] for a, n in mesh_extents(mesh).items()]}
    rules = {} if SEQPAR.get(_module(arch), True) else {"seq_resid": None}
    with (FakeTensorMode(allow_non_fake_inputs=True), _real_index_math(),
          use_rules(mesh, rules)):
        built, why = build_cell(arch, shape_name, mesh)
        if built is None:
            row.update(status="skipped", reason=why)
            return row
        step, args = built
        arg_bytes = argument_bytes(arch, shape_name, mesh)
        rec = StepRecorder(base=arg_bytes)
        with _cost.capture() as kernels, rec:
            out = step(*args)
        out_bytes = _local_tensor_bytes(out)
    kflops = sum(k["flops"] for k in kernels.values())
    kbytes = sum(k["bytes"] for k in kernels.values())
    totals = collective_totals(rec)
    row.update(
        status="ok",
        lower_s=round(time.time() - t0, 1),
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": rec.peak - arg_bytes,
                "peak_bytes": rec.peak},
        cost={"flops": float(rec.flops + kflops),
              "kernel_flops": float(kflops), "kernel_bytes": float(kbytes),
              "aten_flops": {k: float(v) for k, v in sorted(
                  rec.by_op.items(), key=lambda kv: -kv[1])},
              "kernels": {k: v["launches"] for k, v in sorted(
                  kernels.items())}},
        collectives=totals,
        link_bytes=link_bytes(totals),
    )
    return row


def fit_check(row: dict) -> str:
    """The row's per-rank peak against the memory of the card this process
    sees (no verdict without one)."""
    if row.get("status") != "ok" or not torch.cuda.is_available():
        return ""
    total = torch.cuda.get_device_properties(0).total_memory
    peak = row["memory"]["peak_bytes"]
    return (f"fits ({peak / total:.2f} of {total / 2**30:.1f} GiB)"
            if peak <= total else
            f"does not fit ({peak / 2**30:.1f} > {total / 2**30:.1f} GiB)")


_KINDS_SHORT = {"all-gather": "AG", "all-reduce": "AR",
                "reduce-scatter": "RS", "all-to-all": "A2A",
                "collective-permute": "CP"}


def table_row(row: dict) -> str:
    """One markdown row of a cell: per rank the argument and peak GB,
    TFLOP and their ratio to ``analysis.flops.cell_flops`` over the ranks
    (work a rank repeats), collective GB by kind and link GB; host s."""
    head = f"| {row['arch']} | {row['shape']} | {row['mesh']} |"
    if row["status"] != "ok":
        return f"{head} {row['status']}: {row.get('reason', row.get('error'))} |"
    from ..analysis.flops import cell_flops
    ranks = 1
    for _, n in row["mesh_shape"]:
        ranks *= n
    cell = cell_flops(_cfg(row["arch"]), shp.SHAPES[row["shape"]])
    mem, flops = row["memory"], row["cost"]["flops"]
    coll = ", ".join(f"{_KINDS_SHORT[k]} {v / 1e9:.2f}" for k, v in
                     row["collectives"]["bytes"].items() if v)
    return (f"{head} {mem['argument_size_in_bytes'] / 1e9:.2f} | "
            f"{mem['peak_bytes'] / 1e9:.2f} | {flops / 1e12:.3g} "
            f"({flops * ranks / cell.flops:.2f}) | {coll or 'none'} | "
            f"{row['link_bytes'] / 1e9:.2f} | {row['lower_s']} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(shp.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have results")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failures, rows = 0, []
    try:
        for mesh_kind in meshes:
            for arch in args.arch:
                for shape_name in args.shape:
                    path = os.path.join(
                        args.out_dir,
                        f"{_module(arch)}__{shape_name}__{mesh_kind}.json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip-cached] {arch} {shape_name} "
                              f"{mesh_kind}")
                        with open(path) as f:
                            rows.append(json.load(f))
                        continue
                    try:
                        row = run_cell(arch, shape_name, mesh_kind)
                    except Exception as e:
                        traceback.print_exc()
                        row = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_kind, "status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                        failures += 1
                    with open(path, "w") as f:
                        json.dump(row, f, indent=1)
                    rows.append(row)
                    mem = row.get("memory", {})
                    cost = row.get("cost", {})
                    print(f"[{row['status']:7s}] {arch} {shape_name} "
                          f"{mesh_kind} lower={row.get('lower_s', 0)}s "
                          f"args="
                          f"{mem.get('argument_size_in_bytes', 0) / 2**30:.2f}"
                          f"GiB "
                          f"peak={mem.get('peak_bytes', 0) / 2**30:.2f}GiB "
                          f"flops={cost.get('flops', 0):.3g} "
                          f"link={row.get('link_bytes', 0) / 2**30:.2f}GiB "
                          f"{fit_check(row)}",
                          flush=True)
    finally:
        destroy_group()
    print("| arch | shape | mesh | args GB | peak GB | TFLOP a rank "
          "(x ranks / cell_flops) | collective GB a rank | link GB | "
          "host s |")
    for row in rows:
        print(table_row(row))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
