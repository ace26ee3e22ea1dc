"""The launchers' ``--mesh debug`` on the CPU: a one-rank mesh (a gloo
group on an in-process store) shards nothing, so every result must equal
the mesh-less run's bit for bit, as ``chip_smoke.py`` requires on the card.

* the train launcher's ``build`` with and without the mesh: equal losses
  and final params, DTensor params and state at ``param_specs``' layout;
* the checkpoint store and ``tree_digest`` read a DTensor tree whole: a
  save restores into the same placements, and the digest is the plain
  tree's;
* the serve launcher's engine with and without the mesh: equal tokens,
  the cache at ``cache_specs``' layout; the static batch equal too;
* both launchers' command lines with ``--mesh debug``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

TRAIN_ARGV = ["--tiny", "--device", "cpu", "--steps", "3", "--global-batch",
              "4", "--seq-len", "32", "--accum", "2", "--seed", "0"]
SERVE_ARGV = ["--arch", "olmo-1b", "--tiny", "--device", "cpu",
              "--requests", "6", "--policy", "crch", "--env", "unstable",
              "--seed", "0"]


@pytest.fixture()
def mesh():
    from repro_torch.launch.mesh import destroy_group, make_debug_mesh
    m = make_debug_mesh(device="cpu")
    yield m
    destroy_group()


def _train(mesh, tmp_path, label):
    from repro_torch.configs import get_config
    from repro_torch.ft import tree_digest
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        TRAIN_ARGV + ["--ckpt-dir", str(tmp_path / label)])
    cfg = get_config("olmo-1b", tiny=True)
    built = launch.build(cfg, args, mesh=mesh)
    params, opt = built["coord"].params, built["coord"].opt_state
    losses = []
    for i in range(args.steps):
        params, opt, m = built["step_fn"](params, opt,
                                          built["pipeline"].batch_at(i))
        losses.append(float(m["loss"]))
    return losses, tree_digest(params), params, opt


def test_train_on_a_one_rank_mesh_is_bit_identical(mesh, tmp_path):
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import spec_to_placements
    from repro_torch.tree import flatten
    want_losses, want_digest, _, _ = _train(None, tmp_path, "plain")
    losses, digest, params, opt = _train(mesh, tmp_path, "mesh")
    assert losses == want_losses
    assert digest == want_digest
    specs = pshard.param_specs(params, mesh)
    for (_, p), (_, spec), (_, mu) in zip(flatten(params), flatten(specs),
                                          flatten(opt["mu"])):
        assert list(p.placements) == spec_to_placements(spec, mesh)
        assert list(mu.placements) == list(p.placements)


def test_checkpoint_and_digest_read_dtensors_whole(mesh, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.ft import CheckpointStore, tree_digest
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    cfg = get_config("olmo-1b", tiny=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1))
    sharded = pshard.distribute_params(params, mesh)
    assert tree_digest(sharded) == tree_digest(params)
    store = CheckpointStore(str(tmp_path / "store"))
    store.save(3, {"params": sharded})
    store.wait()
    zeros = pshard.distribute_params(
        lm.init_params(cfg, torch.Generator().manual_seed(2)), mesh)
    got = store.restore({"params": zeros})
    tree = got[0] if isinstance(got, tuple) else got
    for (_, a), (_, b) in zip(flatten(tree["params"]), flatten(sharded)):
        assert list(a.placements) == list(b.placements)
        assert torch.equal(a.full_tensor(), b.full_tensor())


def test_serve_on_a_one_rank_mesh_gives_the_same_tokens(mesh):
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import spec_to_placements
    from repro_torch.launch import serve as launch
    cfg = get_config("olmo-1b", tiny=True)
    args = launch.build_parser().parse_args(SERVE_ARGV)
    base = launch.continuous_main(cfg, args)
    res = launch.continuous_main(cfg, args, params=base["params"], mesh=mesh)
    assert res["engine"].completed == base["engine"].completed
    cache = res["engine"].cache
    specs = pshard.cache_specs(cache, cfg, mesh)
    assert all(list(v.placements) == spec_to_placements(specs[k], mesh)
               for k, v in cache.items())
    sargs = launch.build_parser().parse_args(SERVE_ARGV[:5] + [
        "--requests", "3", "--static"])
    plain = launch.static_main(cfg, sargs, params=base["params"])
    sharded = launch.static_main(cfg, sargs, params=base["params"],
                                 mesh=mesh)
    assert torch.equal(plain["tokens"], sharded["tokens"])


@pytest.mark.parametrize("module,argv,expect", [
    ("repro_torch.launch.train", TRAIN_ARGV, "steps=3"),
    ("repro_torch.launch.serve", SERVE_ARGV + ["--verify-static"],
     "parity vs static reference: 6/6 token-exact")])
def test_launchers_take_mesh_debug(module, argv, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *argv, "--mesh",
                          "debug"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert expect in out.stdout


def test_train_step_with_grad_shardings_runs(mesh):
    """The port of ``tests/test_distributed.py``'s check (which fails in
    JAX on jax 0.9): a tiny olmo-1b step with ``grad_shardings`` on the
    debug mesh runs, counts its step, and keeps the fp32 master equal to
    the params."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten
    cfg = get_config("olmo_1b", tiny=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    opt = pshard.distribute_opt_state(adamw_init(params, master=True),
                                      params, mesh)
    step = make_train_step(cfg, accum_steps=2, q_chunk=16, xent_chunk=16,
                           grad_shardings=pshard.param_shardings(params,
                                                                 mesh))
    with use_rules(mesh):
        p2, o2, m = step(pshard.distribute_params(params, mesh), opt,
                         make_batch(cfg, batch=4, seq=32))
    assert np.isfinite(float(m["loss"]))
    assert int(o2["step"]) == 1
    for (_, a), (_, b) in zip(flatten(p2), flatten(o2["master"])):
        np.testing.assert_allclose(a.full_tensor().float().numpy(),
                                   b.full_tensor().float().numpy(),
                                   atol=1e-5)
