"""Training of the MoE family on the port against the JAX package:
granite-moe-1b-a400m (tiny) on the same weights and batches as JAX,
``make_train_step`` over 20 steps (accum 1 and 2), the train launcher
against a JAX ``TrainingCoordinator`` under the injector's crashes,
checkpoints that cross-restore with JAX's under equal sha1s, and the
launcher's command line.  The loss carries the MoE load-balancing loss
(0.01 x aux), as in JAX.

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
ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jax_get_config(ARCH, tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH, tiny=True),
                               compute_dtype="float32")
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _assert_trees_close(tree_t, tree_j, **tol):
    for (name, a), (_, b) in zip(flatten(tree_t), flatten(
            jax.tree.map(np.asarray, tree_j))):
        np.testing.assert_allclose(a.numpy(), b, err_msg=str(name), **tol)


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
    """From the same init (``params_from_jax``, ``state_from_jax``) on the
    same batches, each package on its own for 20 steps: every step's loss
    (xent + 0.01 aux) and gradient norm, and the final params and
    moments."""
    jcfg, tcfg, jparams, np_tree = tiny
    js = jadamw.adamw_init(jparams)
    tp = lm.params_from_jax(np_tree, tcfg, device="cpu")
    ts = adamw.state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    tstep = make_train_step(tcfg, adamw.AdamWConfig(lr=1e-3),
                            accum_steps=accum, q_chunk=32, xent_chunk=16,
                            warmup=3, total_steps=20)
    jpipe = JPipeline(JDataConfig(4, 32, seed=1), jcfg)
    tpipe = SyntheticTokenPipeline(DataConfig(4, 32, seed=1), tcfg)
    jp = jparams
    for i in range(20):
        jp, js, jm = jax_steps[accum](jp, js, jpipe.batch_at(i))
        tp, ts, tm = tstep(tp, ts, tpipe.batch_at(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   err_msg=f"step {i}", **TOL)
    assert int(ts["step"]) == int(js["step"]) == 20
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]),
                           (ts["nu"], js["nu"])):
        _assert_trees_close(tree_t, tree_j, **TOL)


def test_the_loss_carries_the_load_balancing_loss(tiny):
    """The step's loss is forward_train's xent + 0.01 aux, aux > 0."""
    _, tcfg, _, np_tree = tiny
    params = lm.params_from_jax(np_tree, tcfg, device="cpu")
    batch = SyntheticTokenPipeline(DataConfig(4, 32, seed=1),
                                   tcfg).batch_at(0)
    with torch.no_grad():
        loss, m = lm.forward_train(params, tcfg, {
            k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(m["aux"]) > 0
    np.testing.assert_allclose(float(loss),
                               float(m["xent"]) + 0.01 * float(m["aux"]),
                               rtol=1e-6)
    _, _, tm = make_train_step(tcfg)(params, adamw.adamw_init(params), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=1e-6)


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
    args = launch.build_parser().parse_args(
        ["--arch", ARCH] + LAUNCH_ARGS
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
    """The MoE family's params (router and stacked experts) and AdamW
    state: JAX writes, the port restores, and back; both indexes carry the
    same leaf names and the same sha1 per leaf."""
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
    names = sorted(f"{top}/{leaf_name(p)}" for top in ("params", "opt")
                   for p, _ in flatten(ttree[top]))
    assert sorted(want) == names
    assert "params/layers/moe/router" in names


def test_launcher_cli_trains_the_family_under_a_crash():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         *LAUNCH_ARGS], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    name = get_config(ARCH, tiny=True).name
    run = [l for l in lines if l.startswith(f"arch={name} ")]
    assert run and "steps=12 " in run[0] and "restores=0" not in run[0]
    assert any(l.startswith("loss: first10%=") for l in lines)
