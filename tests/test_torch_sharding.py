"""The port's sharding layer against the JAX package's, spec for spec:
``param_specs`` (ZeRO-1 on and off), ``opt_state_specs`` (with the fp32
master), ``batch_specs`` and ``cache_specs`` for the ten families on the
(1, 1), (16, 16) and (2, 16, 16) meshes (JAX's ``AbstractMesh``: no devices
needed), ``logical_to_spec`` and ``constrain``'s divisibility guard, the
spec-to-placement helper's per-rank shards, and ports of the JAX checks in
``tests/test_distributed.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import params as jparams  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import params as pshard  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import (P, MeshShape,  # noqa: E402
                                              constrain, guard_spec,
                                              logical_to_spec,
                                              spec_to_placements, use_rules)
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return MeshShape(shape, axes), AbstractMesh(shape, axes)


def _norm(part):
    """A spec entry with a one-axis tuple read as the axis itself."""
    if isinstance(part, tuple) and len(part) == 1:
        return part[0]
    return part


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(tuple(k.key for k in path), tuple(map(_norm, s)))
            for path, s in flat]


def _port_spec_leaves(tree):
    # a spec is a tuple, a leaf of the port's trees
    return [(path, tuple(map(_norm, s))) for path, s in flatten(tree)]


def _abstract(arch):
    jcfg = jax_get_config(arch)
    jab = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    return get_config(arch), lm.abstract_params(get_config(arch)), jcfg, jab


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_jax(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg, ab, jcfg, jab = _abstract(arch)
    for zero1 in (False, True):
        got = _port_spec_leaves(pshard.param_specs(ab, mesh, zero1=zero1))
        want = _jax_specs(jparams.param_specs(jab, jmesh, zero1=zero1))
        assert got == want, (arch, mesh_name, zero1)
    opt = {"mu": ab, "nu": ab, "master": ab, "step": torch.zeros(())}
    jopt = jax.eval_shape(lambda p: jadamw_init(p, master=True), jab)
    got = pshard.opt_state_specs(opt, ab, mesh, zero1=True)
    want = jparams.opt_state_specs(jopt, jab, jmesh, zero1=True)
    assert set(got) == set(want) == {"mu", "nu", "master", "step"}
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    for k in ("mu", "nu", "master"):
        assert _port_spec_leaves(got[k]) == _jax_specs(want[k]), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape, jshape = shapes.SHAPES[name], jshapes.SHAPES[name]
        specs = shapes.input_specs(cfg, shape)
        jspecs = jshapes.input_specs(jcfg, jshape)
        if shape.kind == "decode":
            got = _port_spec_leaves(
                pshard.cache_specs(specs["cache"], cfg, mesh))
            want = _jax_specs(jparams.cache_specs(jspecs["cache"], jcfg,
                                                  jmesh))
            assert got == want, (name, "cache")
            got = _port_spec_leaves(pshard.batch_specs(
                {"tokens": specs["tokens"], "pos": specs["pos"]}, mesh))
            want = _jax_specs(jparams.batch_specs(
                {"tokens": jspecs["tokens"], "pos": jspecs["pos"]}, jmesh))
        else:
            got = _port_spec_leaves(pshard.batch_specs(specs, mesh))
            want = _jax_specs(jparams.batch_specs(jspecs, jmesh))
        assert got == want, name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_spec_and_guard_equal_jax(mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    axes_sets = [("batch", "seq_resid", "embed"), ("batch", "seq", None, None),
                 ("batch", "kv_heads", None, "kv_seq"), ("batch", "vocab"),
                 (None, "experts", "expert_capacity", "embed"),
                 ("batch", "seq", "mlp"), ("batch", "seq", "lru"),
                 ("fsdp", "heads", "frames", "head_dim")]
    shapes_ = [(1, 1500, 768, 64), (256, 4096, 48, 128), (32, 40, 3, 16)]
    for rules in (None, {"seq_resid": None}):
        for axes in axes_sets:
            with use_rules(mesh, rules), jsharding.use_rules(jmesh, rules):
                got = logical_to_spec(axes)
                want = jsharding.logical_to_spec(axes)
                assert tuple(map(_norm, got)) == tuple(map(_norm, want))
                for shp in shapes_:
                    shp = shp[:len(axes)]
                    # JAX's guard, sharding.py:84-103, on JAX's spec
                    ext = dict(zip(jmesh.axis_names, jmesh.axis_sizes))
                    jparts = []
                    spec = tuple(want) + (None,) * (len(shp) - len(want))
                    for dim, part in zip(shp, spec):
                        if part is None:
                            jparts.append(None)
                            continue
                        names = part if isinstance(part, tuple) else (part,)
                        size = int(np.prod([ext[a] for a in names]))
                        jparts.append(part if dim % size == 0 else None)
                    assert (tuple(map(_norm, guard_spec(got, shp, mesh)))
                            == tuple(map(_norm, jparts))), (axes, shp)


def test_logical_to_spec_respects_rules():
    mesh = MeshShape((1, 1), ("data", "model"))
    with use_rules(mesh, {"seq_resid": None}):
        assert tuple(logical_to_spec(("batch", "seq_resid", "embed")))[1] \
            is None
    with use_rules(mesh):
        assert tuple(logical_to_spec(("batch", "seq_resid", "embed")))[1] \
            == "model"
    multi = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert tuple(logical_to_spec(("batch", "seq_resid", "embed"),
                                 mesh=multi)) == (("pod", "data"), "model",
                                                  None)


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    dm = MeshShape((2, 2), ("data", "model"))
    assert spec_to_placements(P("data", "model"), dm) == [Shard(0), Shard(1)]
    assert spec_to_placements(P("model", "data"), dm) == [Shard(1), Shard(0)]
    assert spec_to_placements(P(None, "model"), dm) == [Replicate(),
                                                        Shard(1)]
    multi = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert spec_to_placements(P(("pod", "data"), "model", None), multi) == [
        Shard(0), Shard(0), Shard(1)]
    # an axis of one rank holds the whole dimension: replication
    one = MeshShape((1, 1), ("data", "model"))
    assert spec_to_placements(P("data", "model"), one) == [Replicate()] * 2
    with pytest.raises(ValueError):
        spec_to_placements(P("data", "data"), dm)
    with pytest.raises(NotImplementedError):
        spec_to_placements(P(("data", "pod")), multi)


def _rank_shards(world, fn, tmp_path):
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=(world, str(tmp_path)), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(tmp_path / f"r{r}.pt") for r in range(world)]


def _shard_worker(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        x = torch.arange(8 * 4).reshape(8, 4)
        out = {}
        for name, spec in (("pd", P(("pod", "data"), None)),
                           ("p_d", P("pod", "data")),
                           ("d_p", P("data", "pod"))):
            t = distribute_tensor(x, mesh, spec_to_placements(spec, mesh),
                                  src_data_rank=None)
            out[name] = (tuple(mesh.get_coordinate()), t.to_local().clone())
        torch.save(out, f"{tmp}/r{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_placement_shards_per_rank_match_named_sharding(tmp_path):
    """On a (2, 2) ("pod", "data") mesh each rank holds the chunk that
    JAX's NamedSharding gives the device at its coordinates."""
    x = np.arange(8 * 4).reshape(8, 4)
    got = _rank_shards(4, _shard_worker, tmp_path)
    for out in got:
        (p, d), pd = out["pd"]
        # ("pod", "data") on dim 0: pod major, chunk p * 2 + d of 4
        np.testing.assert_array_equal(pd.numpy(), x[(p * 2 + d) * 2:
                                                      (p * 2 + d + 1) * 2])
        _, t = out["p_d"]
        np.testing.assert_array_equal(t.numpy(), x[p * 4:(p + 1) * 4,
                                                   d * 2:(d + 1) * 2])
        _, t = out["d_p"]
        np.testing.assert_array_equal(t.numpy(), x[d * 4:(d + 1) * 4,
                                                   p * 2:(p + 1) * 2])


# -- ports of tests/test_distributed.py's checks ---------------------------

DEBUG = MeshShape((1, 1), ("data", "model"))
PROD = MeshShape((16, 16), ("data", "model"))


@pytest.mark.parametrize("arch", ("deepseek_coder_33b", "phi35_moe_42b",
                                  "recurrentgemma_2b", "rwkv6_3b",
                                  "whisper_small"))
def test_param_specs_cover_all_leaves_and_divide(arch):
    ab = lm.abstract_params(get_config(arch))
    for mesh in (DEBUG, PROD):
        specs = _port_spec_leaves(pshard.param_specs(ab, mesh))
        leaves = flatten(ab)
        assert len(specs) == len(leaves)
        ext = sharding.mesh_extents(mesh)
        for (path, leaf), (spath, spec) in zip(leaves, specs):
            assert path == spath and len(spec) <= leaf.ndim
            for dim, part in zip(leaf.shape, spec):
                if part is None:
                    continue
                axes = part if isinstance(part, tuple) else (part,)
                assert dim % int(np.prod([ext[a] for a in axes])) == 0


def test_zero1_strips_data_axis():
    ab = lm.abstract_params(get_config("olmo_1b"))
    full = [s for _, s in _port_spec_leaves(pshard.param_specs(ab, DEBUG))]
    z1 = [s for _, s in _port_spec_leaves(
        pshard.param_specs(ab, DEBUG, zero1=True))]
    assert any("data" in s for s in full)
    assert not any("data" in s for s in z1)
    assert any("model" in s for s in z1)


def test_opt_specs_keep_master_fully_sharded():
    ab = lm.abstract_params(get_config("olmo_1b"))
    opt = adamw_init(ab, master=True)
    ospec = pshard.opt_state_specs(opt, ab, DEBUG, zero1=True)
    assert "master" in ospec
    assert any("data" in s for _, s in _port_spec_leaves(ospec["master"]))


def test_cache_specs_seq_sharded():
    cfg = get_config("deepseek_coder_33b")
    cache = lm.init_cache(cfg, 128, 32768, device="meta")
    assert tuple(pshard.cache_specs(cache, cfg, DEBUG)["k"]) == (
        None, "data", "model", None, None)


def test_cache_specs_fall_back_when_indivisible():
    cfg = get_config("rwkv6_3b")
    specs = pshard.cache_specs(lm.init_cache(cfg, 1, 1024, device="meta"),
                               cfg, PROD)
    assert tuple(specs["S"])[1] is None and tuple(specs["S"])[2] is None
    assert tuple(specs["x_tm"])[2] == "model"


def test_param_specs_fall_back_for_indivisible_vocab():
    ab = lm.abstract_params(get_config("granite_moe_1b"))
    embed = tuple(pshard.param_specs(ab, PROD)["embed"])
    assert embed[0] is None and embed[1] == "data"


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert constrain(x, ("batch", "embed")) is x


def test_constrain_refuses_a_plain_tensor_inside_a_scope():
    with use_rules(DEBUG):
        with pytest.raises(TypeError):
            constrain(torch.ones(3, 5), ("batch", "mlp"))


def test_cells_supported_and_skipped():
    """The 40 cells: 32 supported, 8 skips with JAX's reason (the JAX
    check counts the same)."""
    ok = skip = 0
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in shapes.SHAPES:
            got = shapes.cell_supported(cfg, shapes.SHAPES[name])
            assert got == jshapes.cell_supported(jcfg, jshapes.SHAPES[name])
            ok, skip = ok + got[0], skip + (not got[0])
    assert (ok, skip) == (32, 8)
