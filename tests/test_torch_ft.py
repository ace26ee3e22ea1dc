"""The port's fault-tolerance layer against the JAX package: the pointer
checkpoint store (same files, names and hashes; checkpoints cross-restore
between the packages), the training coordinator under failures and every
train-side chaos class (the same report as JAX's coordinator on the same
trace, weights and batches), the straggler replication planner and the
failure injector.

Losses are held at fp32 atol=rtol=2e-4; counts and plans exactly.
"""
import collections
import dataclasses
import hashlib
import json

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import chaos as jchaos  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.distributed.steps import make_train_step as jmake  # noqa: E402
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.ft import DynamicInterval as JInterval  # noqa: E402
from repro.ft import FaultInjector as JInjector  # noqa: E402
from repro.ft import HostTelemetry as JTelemetry  # noqa: E402
from repro.ft import ReplicationPlanner as JPlanner  # noqa: E402
from repro.ft import TrainingCoordinator as JCoordinator  # noqa: E402
from repro.ft.coordinator import CoordinatorReport as JReport  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import chaos  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.distributed import make_train_step  # noqa: E402
from repro_torch.ft import (CheckpointStore, CoordinatorReport,  # noqa: E402
                            DynamicInterval, FaultInjector, HostTelemetry,
                            ReplicationPlanner, TrainingCoordinator)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw_init, state_from_jax  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.normal(size=(8, 4)).astype(np.float32),
                       "final_norm": {},
                       "layers": {"attn": {"wq": rng.normal(
                           size=(2, 4, 4)).astype(np.float32)},
                           "ln1": {}}},
            "opt": {"step": np.array(3, np.int32),
                    "mu": {"embed": rng.normal(size=(8, 4)).astype(
                        np.float32)}}}


def _torch_tree(np_tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), np_tree)


def _index_leaves(store, step):
    idx = store.read_index(step)
    return {name: {k: m[k] for k in ("sha1", "shape", "dtype")}
            for name, m in idx["leaves"].items()}


# ---------------------------------------------------------------------------
# checkpoint store
# ---------------------------------------------------------------------------

def test_store_roundtrip_has_jax_names_and_hashes(tmp_path):
    np_tree = _tree()
    tt = _torch_tree(np_tree)
    store = CheckpointStore(str(tmp_path / "port"))
    store.save(3, tt, extra={"next_index": 4, "seed": 0})
    jstore = JStore(str(tmp_path / "jax"))
    jstore.save(3, jax.tree.map(jnp.asarray, np_tree),
                extra={"next_index": 4, "seed": 0})
    assert _index_leaves(store, 3) == _index_leaves(jstore, 3)
    assert sorted(_index_leaves(store, 3)) == [
        "opt/mu/embed", "opt/step", "params/embed",
        "params/layers/attn/wq"]
    out, step, extra = store.restore(tt)
    assert step == 3 and extra == {"next_index": 4, "seed": 0}
    assert out["params"]["final_norm"] == {} and out["params"]["layers"][
        "ln1"] == {}
    for (pa, a), (_, b) in zip(flatten(out), flatten(tt)):
        assert a.dtype == b.dtype and a.device == b.device, pa
        assert torch.equal(a, b), pa
    assert out["opt"]["step"].dtype == torch.int32


def test_checkpoints_cross_restore_between_the_packages(tmp_path):
    """The tiny olmo's params and AdamW state: JAX writes, the port
    restores, and back; both indexes carry the same sha1 per leaf."""
    jcfg = jax_get_config("olmo-1b", tiny=True)
    tcfg = get_config("olmo-1b", tiny=True)
    jparams = jlm.init_params(jax.random.key(1), jcfg)
    jtree = {"params": jparams, "opt": jadamw_init(jparams)}
    np_tree = jax.tree.map(np.asarray, jtree)
    ttree = {"params": lm.params_from_jax(np_tree["params"], tcfg,
                                          device="cpu"),
             "opt": state_from_jax(np_tree["opt"], device="cpu")}
    JStore(str(tmp_path / "a")).save(5, jtree, extra={"seed": 0})
    port_view = CheckpointStore(str(tmp_path / "a"))
    got, step, _ = port_view.restore(ttree)
    assert step == 5
    for (pa, a), (_, b) in zip(flatten(got), flatten(np_tree)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(pa))
    CheckpointStore(str(tmp_path / "b")).save(6, ttree, extra={"seed": 0})
    jgot, jstep, _ = JStore(str(tmp_path / "b")).restore(jtree)
    assert jstep == 6
    for (pa, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, jgot)),
                               flatten(np_tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
    assert (_index_leaves(port_view, 5)
            == _index_leaves(CheckpointStore(str(tmp_path / "b")), 6))


def test_corrupt_newest_checkpoint_falls_back_and_quarantines(tmp_path):
    tt = _torch_tree(_tree())
    store = CheckpointStore(str(tmp_path))
    store.save(1, tt)
    tt2 = tree_map(lambda t: t + 1 if t.is_floating_point() else t, tt)
    store.save(2, tt2)
    path = chaos.corrupt_checkpoint_shard(store, seed=7)
    assert path is not None
    out, step, _ = store.restore(tt)
    assert step == 1 and store.last_restore_fallbacks == 1
    assert store.quarantined and store.quarantined[0]["path"] == path
    assert torch.equal(out["params"]["embed"], tt["params"]["embed"])
    # the failed index is retired: the next restore goes straight to step 1
    assert store.committed_steps() == [1]
    chaos.corrupt_checkpoint_shard(store, seed=1)
    with pytest.raises(IOError):
        store.restore(tt)


def test_async_save_copies_before_the_writer_starts(tmp_path):
    """Torch tensors are mutable: an in-place update right after an async
    save must not reach the checkpoint (nor its hash)."""
    tt = _torch_tree(_tree())
    want = {name: t.clone() for name, t in flatten(tt)}
    store = CheckpointStore(str(tmp_path))
    assert store.save(4, tt, sync=False) == {"step": 4, "async": True}
    for _, t in flatten(tt):
        t.add_(1)
    store.wait()
    assert store.verify_committed() == []
    out, step, _ = store.restore(tt)
    assert step == 4
    for name, t in flatten(out):
        assert torch.equal(t, want[name]), name


def test_async_save_failure_surfaces_at_wait(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.inject_disk_full()
    store.save(1, _torch_tree(_tree()), sync=False)
    with pytest.raises(OSError):
        store.wait()
    assert store.committed_steps() == []


def test_enospc_prunes_oldest_and_retries(tmp_path):
    tt = _torch_tree(_tree())
    store = CheckpointStore(str(tmp_path), keep=3)
    store.save(1, tt)
    store.save(2, tt)
    store.inject_disk_full()
    store.save(3, tt)
    assert store.enospc_retries == 1 and store.pruned_for_space == [1]
    assert store.committed_steps() == [2, 3]
    assert store.verify_committed() == []
    empty = CheckpointStore(str(tmp_path / "empty"))
    empty.inject_disk_full()
    with pytest.raises(OSError):
        empty.save(1, tt)
    assert empty.committed_steps() == []


def test_store_keeps_the_last_commits(tmp_path):
    tt = _torch_tree(_tree())
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in range(5):
        store.save(step, tt)
    assert store.committed_steps() == [3, 4]
    assert store.latest_step() == 4


# ---------------------------------------------------------------------------
# training coordinator
# ---------------------------------------------------------------------------

def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module")
def train_setup():
    """JAX's tiny olmo (fp32) and the port's, on JAX's init; the two train
    steps with the settings of ``tests/test_chaos.py``."""
    jcfg = _fp32(jax_get_config("olmo-1b", tiny=True))
    tcfg = _fp32(get_config("olmo-1b", tiny=True))
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    jstep = jax.jit(jmake(jcfg, q_chunk=16, xent_chunk=16))
    tstep = make_train_step(tcfg, q_chunk=16, xent_chunk=16)
    return jcfg, tcfg, jparams, np_params, jstep, tstep


def _pair(train_setup, tmp_path, *, trace=None, injector=None, lam=2.0,
          name="ckpt"):
    """A JAX coordinator and a port coordinator on the same weights, data,
    cadence, faults."""
    jcfg, tcfg, jparams, np_params, jstep, tstep = train_setup
    data = dict(global_batch=4, seq_len=32)
    jinj = tinj = None
    if injector is not None:
        jinj = JInjector(mtbf_steps=10.0, mttr_steps=injector["mttr"],
                         seed=0, horizon_steps=0)
        jinj.fail_steps = collections.Counter(injector["steps"])
        tinj = FaultInjector(mtbf_steps=10.0, mttr_steps=injector["mttr"],
                             seed=0, horizon_steps=0)
        tinj.fail_steps = collections.Counter(injector["steps"])
    jc = JCoordinator(
        train_step=jstep, params=jparams, opt_state=jadamw_init(jparams),
        pipeline=JPipeline(JDataConfig(**data), jcfg),
        store=JStore(str(tmp_path / f"{name}_jax")),
        interval=JInterval(gamma_s=1.0, lam_min=lam, lam_max=lam),
        injector=jinj,
        chaos=(jchaos.ChaosEngine(jchaos.FaultTrace.from_json(trace))
               if trace else None))
    params = lm.params_from_jax(np_params, tcfg, device="cpu")
    tc = TrainingCoordinator(
        train_step=tstep, params=params, opt_state=adamw_init(params),
        pipeline=SyntheticTokenPipeline(DataConfig(**data), tcfg),
        store=CheckpointStore(str(tmp_path / f"{name}_port")),
        interval=DynamicInterval(gamma_s=1.0, lam_min=lam, lam_max=lam),
        injector=tinj,
        chaos=(chaos.ChaosEngine(chaos.FaultTrace.from_json(trace))
               if trace else None))
    return jc, tc


def _same_report(got, want):
    for f in dataclasses.fields(want):
        if f.name in ("losses", "final_loss"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    assert len(got.losses) == len(want.losses)


def _trace(*events):
    return {"version": 1, "meta": {}, "events": [
        {"step": s, "kind": k, "targets": list(t), "duration": d, "seed": sd}
        for s, k, t, d, sd in events]}


def test_report_has_the_jax_fields():
    assert ([f.name for f in dataclasses.fields(CoordinatorReport)]
            == [f.name for f in dataclasses.fields(JReport)])


def test_training_survives_failures_and_stays_deterministic(tmp_path,
                                                            train_setup):
    """``tests/test_ft.py``'s determinism check on the port: failures at
    the injector's steps, replay from the checkpoint, final params bit-equal
    to a failure-free run; and the failing run's report equals JAX's."""
    _, tcfg, _, np_params, _, tstep = train_setup

    def port(name, injector):
        params = lm.params_from_jax(np_params, tcfg, device="cpu")
        return TrainingCoordinator(
            train_step=tstep, params=params, opt_state=adamw_init(params),
            pipeline=SyntheticTokenPipeline(DataConfig(4, 32), tcfg),
            store=CheckpointStore(str(tmp_path / name)),
            interval=DynamicInterval(gamma_s=1.0, lam_min=3.0, lam_max=3.0),
            injector=injector)

    a = port("a", None)
    rep_a = a.run(8)
    b = port("b", FaultInjector(mtbf_steps=3.0, seed=1, horizon_steps=8))
    rep_b = b.run(8)
    assert rep_b.failures > 0 and rep_b.restores == rep_b.failures
    assert rep_a.steps_completed == rep_b.steps_completed == 8
    for (name, x), (_, y) in zip(flatten(a.params), flatten(b.params)):
        assert torch.equal(x, y), name
    jc, _ = _pair(train_setup, tmp_path, lam=3.0, name="j")
    jc.injector = JInjector(mtbf_steps=3.0, seed=1, horizon_steps=8)
    _same_report(rep_b, jc.run(8))


def test_train_nan_poison_guard_skips_batch(tmp_path, train_setup):
    jc, tc = _pair(train_setup, tmp_path,
                   trace=_trace((2, chaos.NAN_POISON, (), 0, 0)))
    rep = tc.run(6)
    assert rep.steps_completed == 6
    assert rep.nan_rollbacks == 1 and rep.skipped_batches == 1
    assert all(np.isfinite(rep.losses)) and tc._nan_skip
    _same_report(rep, jc.run(6))


def test_train_ckpt_corrupt_falls_back(tmp_path, train_setup):
    jc, tc = _pair(train_setup, tmp_path, trace=_trace(
        (4, chaos.CKPT_CORRUPT, (), 0, 7), (4, chaos.HOST_CRASH, (), 2, 0)))
    rep = tc.run(8)
    assert rep.steps_completed == 8 and rep.ckpt_corruptions == 1
    assert rep.ckpt_fallbacks >= 1 and rep.restores >= 1
    assert tc.store.quarantined
    _same_report(rep, jc.run(8))


def test_train_escalating_backoff_on_repeated_step(tmp_path, train_setup):
    jc, tc = _pair(train_setup, tmp_path,
                   injector={"steps": {3: 3}, "mttr": 4.0})
    rep = tc.run(6)
    assert rep.steps_completed == 6
    assert rep.failures == 3 and rep.restores == 3
    assert rep.backoff_steps == pytest.approx(16.0)
    assert 3 in tc._ckpt_before
    _same_report(rep, jc.run(6))


def test_train_slowdown_and_capacity_loss(tmp_path, train_setup):
    jc, tc = _pair(train_setup, tmp_path, trace=_trace(
        (1, chaos.SLOWDOWN, (), 5, 0), (3, chaos.CAPACITY_LOSS, (0,), 4, 0)))
    rep = tc.run(6)
    assert rep.steps_completed == 6 and rep.slowdowns == 1
    assert rep.failures == 1 and rep.restores == 1
    _same_report(rep, jc.run(6))


def test_train_disk_full_prunes_and_survives(tmp_path, train_setup):
    jc, tc = _pair(train_setup, tmp_path, trace=_trace(
        (3, chaos.DISK_FULL, (), 0, 0), (3, chaos.HOST_CRASH, (), 2, 0)))
    rep = tc.run(8)
    assert rep.steps_completed == 8 and rep.disk_full_events == 1
    assert rep.enospc_retries >= 1 and rep.index_violations == 0
    assert rep.restores >= 1 and all(np.isfinite(rep.losses))
    _same_report(rep, jc.run(8))


def test_train_net_partition_parks_single_actor(tmp_path, train_setup):
    """A partition parks the single actor (virtual time, no state): the
    losses equal a clean run's."""
    jc, tc = _pair(train_setup, tmp_path, trace=_trace(
        (2, chaos.NET_PARTITION, (0,), 4, 0)))
    rep = tc.run(6)
    _, clean = _pair(train_setup, tmp_path, name="clean")
    ref = clean.run(6)
    assert rep.steps_completed == 6 and rep.partitions == 1
    assert rep.parked_steps == pytest.approx(4.0)
    assert rep.failures == 0 and rep.restores == 0
    np.testing.assert_array_equal(rep.losses, ref.losses)
    _same_report(rep, jc.run(6))


def test_train_registry_series_carry_the_report(tmp_path, train_setup):
    _, tc = _pair(train_setup, tmp_path, trace=_trace(
        (2, chaos.NAN_POISON, (), 0, 0), (3, chaos.HOST_CRASH, (), 2, 0)))
    rep = tc.run(5)
    reg = tc.registry
    assert reg.value("train_events_total", kind="restore") == rep.restores
    assert reg.value("train_events_total", kind="nan_rollback") == 1
    assert (reg.value("train_checkpoints_total", mode="sync")
            + reg.value("train_checkpoints_total", mode="async")
            == rep.checkpoints)


# ---------------------------------------------------------------------------
# straggler replication and the failure injector
# ---------------------------------------------------------------------------

def _telemetry(cls, seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for host in range(n):
        slow = host in (3, 7)
        flaky = host == 9
        out.append(cls(
            host=host, mean_step_s=float(rng.normal(1.0, 0.02)
                                         + (1.5 if slow else 0.0)),
            p95_step_s=float(rng.normal(1.3, 0.03) + (2.5 if slow else 0.0)),
            failure_count=float(rng.poisson(0.2) + (6 if flaky else 0)),
            restarts=float(4 if flaky else 0),
            net_mbps=float(rng.normal(900, 10)),
            mem_pressure=float(rng.uniform(0.3, 0.4)),
            ecc_errors=float(3 if flaky else 0),
            thermal_throttle_s=float(20.0 if slow else rng.uniform(0, 1))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replication_planner_plans_equal_jax(seed):
    want = JPlanner().plan(_telemetry(JTelemetry, seed))
    got = ReplicationPlanner(device="cpu").plan(_telemetry(HostTelemetry,
                                                           seed))
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.assignments == want.assignments
    assert got.healthy_hosts == want.healthy_hosts
    assert max(got.counts) > 1   # the outliers got standby replicas


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_injector_schedule_equals_jax(seed):
    a = JInjector(mtbf_steps=7.0, seed=seed, horizon_steps=300)
    b = FaultInjector(mtbf_steps=7.0, seed=seed, horizon_steps=300)
    assert dict(a.fail_steps) == dict(b.fail_steps)
    step = min(a.fail_steps)
    a.defer(step, step + 3)
    b.defer(step, step + 3)
    assert dict(a.fail_steps) == dict(b.fail_steps)


def test_checkpoint_index_is_plain_json_with_pointers(tmp_path):
    store = CheckpointStore(str(tmp_path), n_hosts=2)
    store.save(1, _torch_tree(_tree()))
    with open(store._index_path(1)) as f:
        idx = json.load(f)
    hosts = sorted({m["host"] for m in idx["leaves"].values()})
    assert hosts == [0, 1]
    for m in idx["leaves"].values():
        arr = np.load(m["file"])
        assert hashlib.sha1(arr.tobytes()).hexdigest() == m["sha1"]
