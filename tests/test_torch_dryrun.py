"""The port's dry run and collective count against the JAX package's.

* ``analysis.hlo``: on a 2x2 fake mesh the recorded collectives of known
  redistributions and of a product with known placements have the
  expected kind, count and per-rank bytes; ``link_bytes`` equals JAX's on
  the same totals.
* ``launch.dryrun``: the ``ACCUM`` / ``ZERO1`` / ``SEQPAR`` tables equal
  JAX's (read from its file with ``ast``: importing it would overwrite
  ``XLA_FLAGS``); every cell's per-rank argument bytes on both production
  meshes equal the figure computed from JAX's specs on ``AbstractMesh``
  (leaf bytes over the product of the extents of its sharded dimensions);
  the 8 unsupported cells give JAX's skip reason; and one cell,
  ``olmo-1b x decode_32k x single``, runs end to end under the fake
  process group with JAX's row layout.
"""
import ast
import dataclasses
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.analysis import hlo as jhlo  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import params as jparams  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.analysis import hlo  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed.sharding import MeshShape  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"


def _jax_tables():
    tree = ast.parse(JAX_DRYRUN.read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("ACCUM", "ZERO1", "SEQPAR")):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def _jax_row_keys():
    """The keys JAX's ``run_cell`` writes: its dict literal and the
    keywords of its ``row.update`` calls."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["row"]):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and getattr(node.func.value, "id", None) == "row"
                and node.func.attr == "update"):
            keys |= {k.arg for k in node.keywords}
    assert {"arch", "memory", "collectives", "status"} <= keys
    return keys


def test_tables_equal_jax():
    assert _jax_tables() == {"ACCUM": dryrun.ACCUM, "ZERO1": dryrun.ZERO1,
                             "SEQPAR": dryrun.SEQPAR}


# -- argument bytes from JAX's specs ----------------------------------------

JAX_MESHES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _local(leaf, spec, ext) -> int:
    n = math.prod(leaf.shape) * leaf.dtype.itemsize
    for part in tuple(spec):
        for a in (() if part is None else
                  part if isinstance(part, tuple) else (part,)):
            n //= ext[a]
    return n


def _sum(tree, specs, ext) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(_local(l, s, ext) for l, s in zip(leaves, spec_leaves))


def _jax_argument_bytes(arch, shape_name, kind):
    tables = _jax_tables()
    shape_, axes = JAX_MESHES[kind]
    mesh = AbstractMesh(shape_, axes)
    ext = dict(zip(axes, shape_))
    cfg = dataclasses.replace(jax_get_config(arch), param_dtype="bfloat16")
    shape = jshapes.SHAPES[shape_name]
    zero1 = tables["ZERO1"].get(arch, True)
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), cfg))
    total = _sum(params, jparams.param_specs(params, mesh, zero1=zero1), ext)
    specs = jshapes.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: jadamw_init(p, master=True), params)
        total += _sum(opt, jparams.opt_state_specs(opt, params, mesh,
                                                   zero1=zero1), ext)
        total += _sum(specs, jparams.batch_specs(specs, mesh), ext)
    elif shape.kind == "prefill":
        total += _sum(specs, jparams.batch_specs(specs, mesh), ext)
    else:
        total += _sum(specs["cache"], jparams.cache_specs(specs["cache"], cfg,
                                                          mesh), ext)
        for name in ("tokens", "pos"):
            total += _sum(specs[name], jparams.batch_specs(specs[name], mesh),
                          ext)
    return total


CELLS = [(a, s) for a in ARCHS for s in shapes.SHAPES]


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_argument_bytes_equal_jax_specs(arch, shape_name):
    for kind, (shape_, axes) in JAX_MESHES.items():
        got = dryrun.argument_bytes(arch, shape_name, MeshShape(shape_, axes))
        assert got == _jax_argument_bytes(arch, shape_name, kind), kind


def test_unsupported_cells_give_jax_reason():
    skipped = 0
    for arch, shape_name in CELLS:
        cfg, jcfg = dryrun._cfg(arch), jax_get_config(arch)
        ok, why = shapes.cell_supported(cfg, shapes.SHAPES[shape_name])
        if ok:
            continue
        built, reason = dryrun.build_cell(arch, shape_name, None)
        assert built is None
        assert (False, reason) == jshapes.cell_supported(
            jcfg, jshapes.SHAPES[shape_name])
        skipped += 1
    assert skipped == 8


# -- one cell end to end under the fake process group ------------------------

@pytest.fixture()
def fake_world():
    from repro_torch.launch.mesh import destroy_group
    yield
    destroy_group()


def test_olmo_decode_cell_end_to_end(fake_world):
    row = dryrun.run_cell("olmo_1b", "decode_32k", "single")
    assert row["status"] == "ok", row
    # JAX's row layout, less its compile time and HLO line count (eager
    # PyTorch has neither)
    assert _jax_row_keys() - {"compile_s", "hlo_lines", "reason"} <= set(row)
    assert row["mesh_shape"] == [["data", 16], ["model", 16]]
    mem = row["memory"]
    assert mem["argument_size_in_bytes"] == _jax_argument_bytes(
        "olmo_1b", "decode_32k", "single")
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert row["cost"]["flops"] > 0
    coll = row["collectives"]
    assert set(coll) == {"bytes", "counts", "bytes_f32", "scaled"}
    assert set(coll["bytes"]) == set(jhlo.COLLECTIVES)
    assert sum(coll["counts"].values()) > 0
    assert row["link_bytes"] == jhlo.link_bytes(coll)


def test_constrain_divisibility_guard(fake_world):
    """The port of ``tests/test_distributed.py``'s check (which fails in
    JAX on jax 0.9): on a 2x2 mesh a (3, 5) activation constrained to
    ("batch", "mlp") divides neither axis and stays replicated."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import constrain, use_rules
    from repro_torch.launch.mesh import init_fake_group
    init_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.ones(3, 5), mesh, [Replicate(), Replicate()])
    with use_rules(mesh):
        y = constrain(x, ("batch", "mlp"))
        z = constrain(DTensor.from_local(torch.ones(2, 6), mesh,
                                         [Replicate(), Replicate()]),
                      ("batch", "mlp"))
    assert y.shape == x.shape
    assert tuple(y.placements) == (Replicate(), Replicate())
    # where the axes divide, the same call shards
    assert [p.dim for p in z.placements] == [0, 1]


# -- the collective count ----------------------------------------------------

def test_collective_count_on_known_placements(fake_world):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import init_fake_group
    from torch.distributed.device_mesh import init_device_mesh
    init_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    log = hlo.CollectiveLog()
    with log:
        # a product with the contraction split over "model": local work,
        # a partial sum
        x = DTensor.from_local(torch.ones(8, 8), mesh,
                               [Replicate(), Shard(1)])
        w = DTensor.from_local(torch.ones(8, 4), mesh,
                               [Replicate(), Shard(0)])
        y = x @ w
        assert tuple(y.placements) == (Replicate(), Partial())
        # partial -> replicated: one all-reduce of the (8, 4) fp32 result
        y.redistribute(mesh, [Replicate(), Replicate()])
        # sharded -> replicated: one all-gather to (8, 16) fp32
        DTensor.from_local(torch.ones(4, 16), mesh, [Shard(0), Replicate()]
                           ).redistribute(mesh, [Replicate(), Replicate()])
        # partial -> sharded: one reduce-scatter to (2, 4) bf16
        DTensor.from_local(torch.ones(4, 4, dtype=torch.bfloat16), mesh,
                           [Partial(), Replicate()]
                           ).redistribute(mesh, [Shard(0), Replicate()])
    totals = hlo.collective_totals(log)
    assert totals["counts"] == {"all-gather": 1, "all-reduce": 1,
                                "reduce-scatter": 1, "all-to-all": 0,
                                "collective-permute": 0}
    assert totals["bytes"] == {"all-gather": 8 * 16 * 4,
                               "all-reduce": 8 * 4 * 4,
                               "reduce-scatter": 2 * 4 * 2,
                               "all-to-all": 0, "collective-permute": 0}
    assert totals["bytes_f32"]["reduce-scatter"] == 0
    assert totals["bytes_f32"]["all-gather"] == 8 * 16 * 4
    assert totals["scaled"] is True
    assert hlo.COLLECTIVES == jhlo.COLLECTIVES
    assert hlo.LINK_FACTOR == jhlo.LINK_FACTOR
    assert hlo.link_bytes(totals) == jhlo.link_bytes(totals)
