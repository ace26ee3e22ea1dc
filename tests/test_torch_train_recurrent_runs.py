"""Training of the recurrent families on the port against the JAX package,
part 2: training runs of rwkv6-3b and recurrentgemma-2b (tiny), on the same
weights and batches as JAX: ``make_train_step`` over 20 steps (accum 1 and
2), the train launcher against a JAX ``TrainingCoordinator`` under a forced
crash, the AdamW state's mapping, checkpoints that cross-restore with
JAX's under equal sha1s, and the launcher's command line.

Tolerances: fp32 atol=rtol=2e-4 (the JAX kernel tests' limit); counts and
hashes exactly.  Everything runs in fp32 on the CPU.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.distributed.steps import make_train_step as jmake  # noqa: E402
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.ft import DynamicInterval as JInterval  # noqa: E402
from repro.ft import FaultInjector as JInjector  # noqa: E402
from repro.ft import TrainingCoordinator as JCoordinator  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.distributed import make_train_step  # noqa: E402
from repro_torch.ft import CheckpointStore  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten, leaf_name  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-4, rtol=2e-4)
FAMILIES = ("rwkv6-3b", "recurrentgemma-2b")


@pytest.fixture(scope="module", params=FAMILIES)
def tiny(request):
    jcfg = dataclasses.replace(jax_get_config(request.param, tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(request.param, tiny=True),
                               compute_dtype="float32")
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _assert_trees_close(tree_t, tree_j, **tol):
    for (name, a), (_, b) in zip(flatten(tree_t), flatten(
            jax.tree.map(np.asarray, tree_j))):
        np.testing.assert_allclose(a.numpy(), b, err_msg=str(name), **tol)


# ---------------------------------------------------------------------------
# the optimizer state and make_train_step
# ---------------------------------------------------------------------------

def test_adamw_state_from_jax_maps_every_leaf(tiny):
    """``state_from_jax`` on the rwkv and hybrid trees: every leaf of mu and
    nu, under JAX's names and in JAX's order, and the step."""
    _, tcfg, jparams, np_tree = tiny
    js = jax.tree.map(np.asarray, jadamw.adamw_init(jparams))
    js["mu"] = jax.tree.map(lambda a: a + 1.5, js["mu"])
    ts = adamw.state_from_jax(js, device="cpu")
    tp = lm.params_from_jax(np_tree, tcfg, device="cpu")
    for key in ("mu", "nu"):
        names = [leaf_name(p) for p, _ in flatten(ts[key])]
        assert names == [leaf_name(p) for p, _ in flatten(tp)]
        assert names == ["/".join(str(k.key) for k in path) for path, _ in
                         jax.tree_util.tree_flatten_with_path(js[key])[0]]
        _assert_trees_close(ts[key], js[key], atol=0, rtol=0)
    assert int(ts["step"]) == 0


@pytest.fixture(scope="module")
def jax_steps(tiny):
    jcfg = tiny[0]
    return {accum: jax.jit(jmake(jcfg, jadamw.AdamWConfig(lr=1e-3),
                                 accum_steps=accum, q_chunk=32,
                                 xent_chunk=16, warmup=3, total_steps=20))
            for accum in (1, 2)}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_trajectory_matches_jax_over_20_steps(tiny, jax_steps,
                                                         accum):
    """JAX's 20-step trajectory, step by step: each step of the port starts
    from JAX's params and state of that step (``params_from_jax``,
    ``state_from_jax``) on the same batch; its loss, gradient norm, new
    params and moments are held to JAX's.  Each step starts from JAX's
    state, not the port's own, because a free-running rwkv6 trajectory
    parts at step 10: the two packages' gradients agree to ~2e-7 at equal
    params, but an embedding element whose gradient is ~1e-6 gets opposite
    signs once the params differ by ~1e-5, and AdamW's first update of it
    is lr times that sign (measured on this tiny config, lr 1e-3)."""
    jcfg, tcfg, jparams, _ = tiny
    tstep = make_train_step(tcfg, adamw.AdamWConfig(lr=1e-3),
                            accum_steps=accum, q_chunk=32, xent_chunk=16,
                            warmup=3, total_steps=20)
    jpipe = JPipeline(JDataConfig(4, 32, seed=1), jcfg)
    tpipe = SyntheticTokenPipeline(DataConfig(4, 32, seed=1), tcfg)
    jp, js = jparams, jadamw.adamw_init(jparams)
    for i in range(20):
        tp = lm.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
        ts = adamw.state_from_jax(jax.tree.map(np.asarray, js),
                                  device="cpu")
        jp, js, jm = jax_steps[accum](jp, js, jpipe.batch_at(i))
        tp, ts, tm = tstep(tp, ts, tpipe.batch_at(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   err_msg=f"step {i}", **TOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]),
                               (ts["nu"], js["nu"])):
            _assert_trees_close(tree_t, tree_j, **TOL)


# ---------------------------------------------------------------------------
# the launcher under a forced crash, and checkpoints
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--tiny", "--device", "cpu", "--steps", "12",
               "--global-batch", "4", "--seq-len", "32",
               "--inject-mtbf-steps", "5", "--seed", "0"]


def test_launcher_matches_a_jax_coordinator(tmp_path, tiny):
    """``launch/train.py``'s code path on JAX's init in fp32, under the
    Weibull injector's crashes, against a ``TrainingCoordinator`` of the
    JAX package built without a mesh with the same settings: the same
    failures, restores, replayed steps and checkpoints, the same losses
    and the same final params."""
    jcfg, tcfg, jparams, np_tree = tiny
    arch = next(a for a in FAMILIES
                if get_config(a, tiny=True).name == tcfg.name)
    args = launch.build_parser().parse_args(
        ["--arch", arch] + LAUNCH_ARGS
        + ["--ckpt-dir", str(tmp_path / "port")])
    built = launch.build(tcfg, args, params=lm.params_from_jax(
        np_tree, tcfg, device="cpu"))
    got = launch.run(tcfg, args, built)
    jcoord = JCoordinator(
        train_step=jax.jit(jmake(jcfg, jadamw.AdamWConfig(lr=3e-4),
                                 q_chunk=32, xent_chunk=512,
                                 total_steps=12)),
        params=jparams, opt_state=jadamw.adamw_init(jparams),
        pipeline=JPipeline(JDataConfig(4, 32, seed=0), jcfg),
        store=JStore(str(tmp_path / "jax")),
        interval=JInterval(gamma_s=5.0),
        injector=JInjector(mtbf_steps=5.0, seed=0, horizon_steps=12))
    want = jcoord.run(12)
    rep = got["report"]
    assert want.failures > 0 and rep.restores == rep.failures
    for field in ("steps_completed", "failures", "restores", "wasted_steps",
                  "checkpoints", "index_violations"):
        assert getattr(rep, field) == getattr(want, field), field
    np.testing.assert_allclose(rep.losses, want.losses, **TOL)
    _assert_trees_close(got["coord"].params, jcoord.params, **TOL)


def _index_leaves(store, step):
    idx = store.read_index(step)
    return {name: {k: m[k] for k in ("sha1", "shape", "dtype")}
            for name, m in idx["leaves"].items()}


def test_checkpoints_cross_restore_between_the_packages(tmp_path, tiny):
    """The tiny family's params and AdamW state: JAX writes, the port
    restores, and back; both indexes carry the same leaf names and the same
    sha1 per leaf."""
    _, tcfg, jparams, np_tree = tiny
    jtree = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    np_full = jax.tree.map(np.asarray, jtree)
    ttree = {"params": lm.params_from_jax(np_tree, tcfg, device="cpu"),
             "opt": adamw.state_from_jax(np_full["opt"], device="cpu")}
    JStore(str(tmp_path / "a")).save(5, jtree, extra={"seed": 0})
    port_view = CheckpointStore(str(tmp_path / "a"))
    got, step, _ = port_view.restore(ttree)
    assert step == 5
    for (pa, a), (_, b) in zip(flatten(got), flatten(np_full)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(pa))
    CheckpointStore(str(tmp_path / "b")).save(6, ttree, extra={"seed": 0})
    jgot, jstep, _ = JStore(str(tmp_path / "b")).restore(jtree)
    assert jstep == 6
    for (pa, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, jgot)),
                               flatten(np_full)):
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
    want = _index_leaves(port_view, 5)
    assert want == _index_leaves(CheckpointStore(str(tmp_path / "b")), 6)
    assert sorted(want) == sorted(
        f"{top}/{leaf_name(p)}" for top in ("params", "opt")
        for p, _ in flatten(ttree[top]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_cli_trains_the_family_under_a_crash(arch):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         *LAUNCH_ARGS], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    name = get_config(arch, tiny=True).name
    run = [l for l in lines if l.startswith(f"arch={name} ")]
    assert run and "steps=12 " in run[0] and "restores=0" not in run[0]
    assert any(l.startswith("loss: first10%=") for l in lines)
