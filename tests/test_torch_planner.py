"""The port's CRCH workflow planner against the JAX package, on the CPU.

Every module from workflow generation through HEFT, the Lemma-3.1 interval,
the simulator, the metrics, the baselines, the RI counts and the DAX reader
is a copy and must give exactly the JAX package's results on the same
seeds.  PCA differs: ``torch.linalg.svd`` and ``jnp.linalg.svd`` round
differently in fp32 (up to ~1e-5 in the projections), and the triplet merge
loop may then break a near-tie the other way.  So ``crch.plan`` fed JAX's
projection must equal JAX's plan exactly, and ``crch.plan`` on its own PCA
must equal JAX's plan or pass the near-tie rule
(``repro_torch.core.clustering.compare_merges``).  On the 24 end-to-end
cases below (4 types x sizes 50/100/300 x seeds 0/1) the replication counts
were equal on 22; montage-300 seed 1 and ligo-100 seed 0 differ, each by
one merge of the same pair in the other direction.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import checkpoint_policy as jckpt  # noqa: E402
from repro.core import mlp_classifier as jmlp  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import checkpoint_policy as tckpt  # noqa: E402
from repro_torch.core import clustering as tclust  # noqa: E402
from repro_torch.core import crch as tcrch  # noqa: E402
from repro_torch.core import mlp_classifier as tmlp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("montage", "cybershake", "ligo", "sipht")
ENVS = ("stable", "normal", "unstable")
E2E_CASES = [(k, n, s) for k in KINDS for n in (50, 100, 300) for s in (0, 1)]
# the two end-to-end cases whose replication counts differ (see above)
DIVERGENT = [("montage", 300, 1), ("ligo", 100, 0)]


def _setup(mod, kind, size, seed):
    wf = mod.generate_workflow(kind, size, seed=seed)
    return wf, mod.CloudEnvironment(wf, 20, seed=seed + 1)


def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def _same_schedule(a, b):
    assert [_fields(p) for p in a.placements] == \
        [_fields(p) for p in b.placements]
    np.testing.assert_array_equal(a.ranks, b.ranks)
    assert a.makespan == b.makespan
    assert a.critical_path() == b.critical_path()


def _as_port_clustering(jres, points):
    """JAX's ClusteringResult with the distances JAX's merges read."""
    return tclust.ClusteringResult(
        labels=jres.labels, cluster_sizes=jres.cluster_sizes,
        merge_history=jres.merge_history,
        min_intercluster_distance=jres.min_intercluster_distance,
        point_distances=J.pairwise_distances(points))


# ---------------------------------------------------------------------------
# the copies: exact equality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size,seed", [(50, 0), (300, 3)])
def test_generate_workflow_and_environment_equal(kind, size, seed):
    jwf, jenv = _setup(J, kind, size, seed)
    twf, tenv = _setup(T, kind, size, seed)
    assert twf.name == jwf.name
    assert [_fields(t) for t in twf.tasks] == [_fields(t) for t in jwf.tasks]
    assert twf.deps == jwf.deps
    assert twf.parents == jwf.parents and twf.children == jwf.children
    assert twf.topo_order() == jwf.topo_order()
    for attr in ("vm_speed", "time_on_vm", "transfer_rate"):
        np.testing.assert_array_equal(getattr(tenv, attr), getattr(jenv, attr))
    assert T.WORKFLOW_TYPES == J.WORKFLOW_TYPES


@pytest.mark.parametrize("env", ENVS)
def test_sample_failure_trace_equal(env):
    for seed in (0, 7):
        a = J.sample_failure_trace(env, 20, horizon_s=5e4, seed=seed)
        b = T.sample_failure_trace(env, 20, horizon_s=5e4, seed=seed)
        assert _fields(b.env) == _fields(a.env)
        assert b.failing_vms == a.failing_vms
        assert b.downtime == a.downtime
    assert {k: _fields(v) for k, v in T.ENVIRONMENTS.items()} == \
        {k: _fields(v) for k, v in J.ENVIRONMENTS.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_features_equal(kind):
    jwf, jenv = _setup(J, kind, 120, 2)
    twf, tenv = _setup(T, kind, 120, 2)
    np.testing.assert_array_equal(T.task_features(twf, tenv),
                                  J.task_features(jwf, jenv))
    np.testing.assert_array_equal(T.b_levels(twf, tenv), J.b_levels(jwf, jenv))
    np.testing.assert_array_equal(T.t_levels(twf, tenv), J.t_levels(jwf, jenv))
    assert T.FEATURE_NAMES == J.FEATURE_NAMES


@pytest.mark.parametrize("kind", KINDS)
def test_heft_schedule_equal(kind):
    jwf, jenv = _setup(J, kind, 150, 1)
    twf, tenv = _setup(T, kind, 150, 1)
    counts = J.plan(jwf, jenv).rep_counts
    for reps in (1, counts, 4):
        _same_schedule(T.heft_schedule(twf, tenv, reps),
                       J.heft_schedule(jwf, jenv, reps))


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_policy_equal(kind):
    jwf, jenv = _setup(J, kind, 100, 0)
    twf, tenv = _setup(T, kind, 100, 0)
    js, ts = J.heft_schedule(jwf, jenv, 1), T.heft_schedule(twf, tenv, 1)
    for env in ENVS:
        for gamma in (2.0, 10.0):
            assert tckpt.optimal_lambda(ts, T.ENVIRONMENTS[env],
                                        gamma=gamma) == \
                jckpt.optimal_lambda(js, J.ENVIRONMENTS[env], gamma=gamma)
            for lam in (5.0, 60.0, 600.0):
                assert tckpt.model_tet(lam, ts, T.ENVIRONMENTS[env],
                                       gamma=gamma) == \
                    jckpt.model_tet(lam, js, J.ENVIRONMENTS[env], gamma=gamma)
    grid = (20.0, 80.0, 300.0)
    jtr = [J.sample_failure_trace("unstable", 20, 40 * js.makespan, seed=s)
           for s in range(3)]
    ttr = [T.sample_failure_trace("unstable", 20, 40 * ts.makespan, seed=s)
           for s in range(3)]
    assert tckpt.empirical_lambda_grid(ts, ttr, grid, gamma=2.0) == \
        jckpt.empirical_lambda_grid(js, jtr, grid, gamma=2.0)


def _plans_and_configs(mod, base, wf, env, counts, lam):
    """(schedule, SimConfig) of CRCH (given counts and lambda*), HEFT and
    ReplicateAll(3) in package ``mod``."""
    crch_cfg = mod.SimConfig(
        ckpt_levels=(mod.CkptLevel(lam, 2.0, portable=False),),
        resubmit=True, skip_when_complete=True, busy_terminate=True,
        backlog_tol=120.0)
    return {"crch": (mod.heft_schedule(wf, env, counts), crch_cfg),
            "heft": (base.heft_plan(wf, env), base.heft_sim_config()),
            "ra3": (base.replicate_all_plan(wf, env, 3),
                    base.replicate_all_sim_config())}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("env", ENVS)
def test_simulate_and_metrics_equal(kind, env):
    jwf, jenv = _setup(J, kind, 100, 1)
    twf, tenv = _setup(T, kind, 100, 1)
    jp = J.plan(jwf, jenv, environment=env)
    jalgos = _plans_and_configs(J, jbase, jwf, jenv, jp.rep_counts,
                                jp.ckpt_lambda)
    talgos = _plans_and_configs(T, tbase, twf, tenv, jp.rep_counts,
                                jp.ckpt_lambda)
    for name in jalgos:
        (js, jc), (ts, tc) = jalgos[name], talgos[name]
        assert _fields(tc) == _fields(jc)
        jruns, truns = [], []
        for i in range(4):
            jtr = J.sample_failure_trace(env, 20, 40 * js.makespan,
                                         seed=100 + i)
            ttr = T.sample_failure_trace(env, 20, 40 * ts.makespan,
                                         seed=100 + i)
            jr, tr = J.simulate(js, jtr, jc), T.simulate(ts, ttr, tc)
            assert _fields(tr) == _fields(jr)
            jruns.append(J.metrics_from_result(js, jr))
            truns.append(T.metrics_from_result(ts, tr))
            jm, tm = _fields(jruns[-1]), _fields(truns[-1])
            assert tm.keys() == jm.keys()
            for k in jm:    # nan == nan where a run failed (SLR)
                np.testing.assert_array_equal(tm[k], jm[k])
        ja, ta = J.aggregate(jruns), T.aggregate(truns)
        assert ta.keys() == ja.keys()
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k])
    for k, v in J.aggregate([]).items():
        np.testing.assert_array_equal(T.aggregate([])[k], v)


def test_resubmission_impact_counts_equal():
    jwf, jenv = _setup(J, "montage", 60, 1)
    twf, tenv = _setup(T, "montage", 60, 1)
    saved = tenv.time_on_vm
    np.testing.assert_array_equal(
        T.resubmission_impact_counts(twf, tenv, max_rep=4),
        J.resubmission_impact_counts(jwf, jenv, max_rep=4))
    assert tenv.time_on_vm is saved      # restored after the variants


def _extensions_dax():
    path = ROOT / "tests" / "test_core_extensions.py"
    spec = importlib.util.spec_from_file_location("_core_ext", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DAX


def test_parse_dax_equal(tmp_path):
    dax = _extensions_dax()
    jwf, twf = J.parse_dax(dax), T.parse_dax(dax)
    assert twf.name == jwf.name
    assert [_fields(t) for t in twf.tasks] == [_fields(t) for t in jwf.tasks]
    assert twf.deps == jwf.deps
    path = tmp_path / "wf.xml"
    path.write_text(dax)
    assert T.load_dax(str(path)).deps == jwf.deps


# ---------------------------------------------------------------------------
# crch.plan / run
# ---------------------------------------------------------------------------

def _jax_pca_in_port(jpca_res):
    return T.PCAResult(**{f.name: getattr(jpca_res, f.name)
                          for f in dataclasses.fields(T.PCAResult)})


def _plan_fed_jax_pca(monkeypatch, twf, tenv, jp, env):
    """The port's ``crch.plan`` on the CPU with JAX's PCA in place of its
    own fit."""
    with monkeypatch.context() as m:
        m.setattr(tcrch, "fit_pca", lambda feats, thr, device:
                  _jax_pca_in_port(jp.pca))
        return T.plan(twf, tenv, environment=env, device="cpu")


@pytest.mark.parametrize("kind,size,seed", DIVERGENT + [
    ("montage", 100, 0), ("cybershake", 300, 1), ("ligo", 300, 0),
    ("sipht", 100, 1)])
def test_plan_on_jax_projection_equals_jax(monkeypatch, kind, size, seed):
    jwf, jenv = _setup(J, kind, size, seed)
    twf, tenv = _setup(T, kind, size, seed)
    env = ENVS[seed + 1]
    jp = J.plan(jwf, jenv, environment=env)
    tp = _plan_fed_jax_pca(monkeypatch, twf, tenv, jp, env)
    np.testing.assert_array_equal(tp.rep_counts, jp.rep_counts)
    np.testing.assert_array_equal(tp.clustering.labels, jp.clustering.labels)
    # the two plain distance matrices round apart where points nearly
    # coincide (sqrt of cancellation noise, up to ~1e-3): a merge may go the
    # other way on the way to the same clusters
    verdict = tclust.compare_merges(
        tp.clustering, _as_port_clustering(jp.clustering, jp.pca.projected),
        jp.pca.projected, jp.pca.projected)
    assert verdict.ok, verdict
    _same_schedule(tp.schedule, jp.schedule)
    assert tp.ckpt_lambda == jp.ckpt_lambda
    assert _fields(T.sim_config(tp)) == _fields(J.sim_config(jp))
    for i in range(3):
        jtr = J.sample_failure_trace(env, 20, 40 * jp.schedule.makespan,
                                     seed=100 + i)
        ttr = T.sample_failure_trace(env, 20, 40 * tp.schedule.makespan,
                                     seed=100 + i)
        jr = J.simulate(jp.schedule, jtr, J.sim_config(jp))
        tr = T.simulate(tp.schedule, ttr, T.sim_config(tp))
        assert _fields(tr) == _fields(jr)
        assert _fields(T.metrics_from_result(tp.schedule, tr)) == \
            _fields(J.metrics_from_result(jp.schedule, jr))


@pytest.mark.parametrize("kind,size,seed", E2E_CASES)
def test_plan_end_to_end_equal_or_near_tie(kind, size, seed):
    """The port's own PCA and distances: equal to JAX's plan, or the first
    divergent merge passes the near-tie rule.  Equal plans also give equal
    schedules, lambda* and simulated metrics."""
    jwf, jenv = _setup(J, kind, size, seed)
    twf, tenv = _setup(T, kind, size, seed)
    jp = J.plan(jwf, jenv)
    tp = T.plan(twf, tenv, device="cpu")
    assert tp.pca.projected.shape == jp.pca.projected.shape
    np.testing.assert_allclose(np.abs(tp.pca.projected),
                               np.abs(jp.pca.projected), atol=1e-4)
    if np.array_equal(tp.rep_counts, jp.rep_counts):
        _same_schedule(tp.schedule, jp.schedule)
        assert tp.ckpt_lambda == jp.ckpt_lambda
        return
    verdict = tclust.compare_merges(
        tp.clustering, _as_port_clustering(jp.clustering, jp.pca.projected),
        tp.pca.projected, jp.pca.projected)
    assert verdict.ok, verdict


def test_run_equals_jax_run():
    jwf, jenv = _setup(J, "cybershake", 100, 0)
    twf, tenv = _setup(T, "cybershake", 100, 0)
    jtr = J.sample_failure_trace("unstable", 20, 5e4, seed=3)
    ttr = T.sample_failure_trace("unstable", 20, 5e4, seed=3)
    jr, jp = J.run(jwf, jenv, jtr, environment="unstable")
    tr, tp = T.run(twf, tenv, ttr, environment="unstable", device="cpu")
    np.testing.assert_array_equal(tp.rep_counts, jp.rep_counts)
    assert _fields(tr) == _fields(jr)
    assert tr.completed
    assert set(tp.timing) == {"features", "pca", "distances", "merge",
                              "heft", "lambda"}


def test_plan_against_the_pallas_backend_in_interpret_mode():
    """JAX's ``backend="pallas"`` (the TPU kernel in interpret mode) against
    the port's plain distances on the CPU."""
    jwf, jenv = _setup(J, "ligo", 50, 1)
    twf, tenv = _setup(T, "ligo", 50, 1)
    jp = J.plan(jwf, jenv, J.CRCHConfig(backend="pallas"))
    tp = T.plan(twf, tenv, device="cpu")
    pallas_P = J.pairwise_distances(jp.pca.projected, backend="pallas")
    jres = dataclasses.replace(
        _as_port_clustering(jp.clustering, jp.pca.projected),
        point_distances=pallas_P)
    verdict = tclust.compare_merges(tp.clustering, jres, tp.pca.projected,
                                    jp.pca.projected)
    assert verdict.ok, verdict
    if verdict.verdict == "equal":
        np.testing.assert_array_equal(tp.rep_counts, jp.rep_counts)
        _same_schedule(tp.schedule, jp.schedule)


def test_crch_config_has_every_paper_field():
    jf = {f.name: f.default for f in dataclasses.fields(J.CRCHConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.CRCHConfig)}
    assert jf.pop("backend") == "jnp"
    assert tf == jf


# ---------------------------------------------------------------------------
# the near-tie rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,size,seed", DIVERGENT)
def test_near_tie_rule_passes_on_the_known_divergences(kind, size, seed):
    jwf, jenv = _setup(J, kind, size, seed)
    twf, tenv = _setup(T, kind, size, seed)
    jp, tp = J.plan(jwf, jenv), T.plan(twf, tenv, device="cpu")
    assert not np.array_equal(tp.clustering.labels, jp.clustering.labels)
    jres = _as_port_clustering(jp.clustering, jp.pca.projected)
    for a, b, pa, pb in ((tp.clustering, jres, tp.pca.projected,
                          jp.pca.projected),
                         (jres, tp.clustering, jp.pca.projected,
                          tp.pca.projected)):
        verdict = tclust.compare_merges(a, b, pa, pb)
        assert verdict.verdict == "reversed", verdict
        x, y = verdict.pairs
        assert x == y[::-1]


def _argmax_loss(D, R, lam, _orig=tclust._cluster_loss_matrix):
    """The mutant: the merge picks the largest loss, not the smallest (the
    rule caught it on all 24 end-to-end cases when this was written)."""
    L = _orig(D, R, lam)
    return np.where(np.isinf(L), np.inf, -L)


@pytest.mark.parametrize("kind,size,seed", DIVERGENT + [("montage", 100, 0)])
def test_near_tie_rule_fails_on_an_argmax_mutant(monkeypatch, kind, size,
                                                 seed):
    twf, tenv = _setup(T, kind, size, seed)
    pts = T.plan(twf, tenv, device="cpu").pca.projected
    good = tclust.triplet_agglomerate(pts, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(tclust, "_cluster_loss_matrix", _argmax_loss)
        bad = tclust.triplet_agglomerate(pts, device="cpu")
    verdict = tclust.compare_merges(good, bad, pts, pts)
    assert verdict.verdict == "diverged", verdict
    assert max(verdict.excess) > verdict.bound


def test_near_tie_rule_fails_on_a_lambda_mutant():
    """``triplet_lambda`` x 1.1 on one side.  The rule looks only at the
    first divergent merge, where the losses are often small: of the 24
    end-to-end cases this mutant is caught on montage-100 seed 0 (used
    here) and sipht-50 seed 1 and passes as a near-tie on the rest."""
    twf, tenv = _setup(T, "montage", 100, 0)
    pts = T.plan(twf, tenv, device="cpu").pca.projected
    good = tclust.triplet_agglomerate(pts, lam=0.5, device="cpu")
    bad = tclust.triplet_agglomerate(pts, lam=0.55, device="cpu")
    verdict = tclust.compare_merges(good, bad, pts, pts, lam=0.5)
    assert verdict.verdict == "diverged", verdict


@pytest.mark.parametrize("kind", KINDS)
def test_near_tie_rule_is_equal_on_identical_inputs(kind):
    twf, tenv = _setup(T, kind, 100, 1)
    a = T.plan(twf, tenv, device="cpu")
    b = T.plan(twf, tenv, device="cpu")
    verdict = tclust.compare_merges(a.clustering, b.clustering,
                                    a.pca.projected, b.pca.projected)
    assert verdict.verdict == "equal" and verdict.ok
    np.testing.assert_array_equal(a.rep_counts, b.rep_counts)


def test_cancellation_bound_is_the_diagonal_rule():
    pts = np.random.default_rng(0).normal(size=(40, 1))
    c = tclust.cancellation_bound(pts)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(np.diag(c),
                               np.sqrt(8 * eps * (pts ** 2).sum(1)))
    # the plain version's error on every pair lies inside it
    got = tclust.pairwise_distances(pts).astype(np.float64)
    exact = np.abs(pts - pts.T)
    assert (np.abs(got - exact) <= c).all()


@pytest.mark.parametrize("kind", KINDS)
def test_distance_rule_at_the_planner_points(kind):
    """B1's limit at the 700-task projections (the card check's rule, on
    the CPU): JAX's plain distances against the port's on the same points
    pass it, though pairs of near-coincident tasks differ by up to ~1e-3;
    a 1% error on the far pairs fails it."""
    jwf, jenv = _setup(J, kind, 700, 1)
    pts = J.fit_pca(J.task_features(jwf, jenv)).projected
    assert pts.shape[1] == 1
    want = J.pairwise_distances(pts)
    got = tclust.pairwise_distances(np.array(pts))
    bad, n_close = tclust.distance_faults(pts, got, want)
    assert not bad.any() and n_close >= pts.shape[0]
    bad, _ = tclust.distance_faults(pts, got * 1.01, want)
    assert bad.any()


# ---------------------------------------------------------------------------
# the MLP learner
# ---------------------------------------------------------------------------

# fp32 over 20 Adam steps: the loss within 2e-4; after 400 steps the logits
# within 5e-4, so predictions must agree wherever JAX's top-two logit gap
# exceeds twice that
MLP_LOSS_TOL = 2e-4
MLP_LOGIT_TOL = 5e-4


def test_mlp_trajectory_matches_jax_from_jax_init():
    jwf, jenv = _setup(J, "montage", 300, 1)
    jp = J.plan(jwf, jenv)
    feats, y = J.task_features(jwf, jenv), jp.rep_counts
    cfg = jmlp.MLPConfig(n_features=feats.shape[1],
                         n_classes=int(y.max()), epochs=400, seed=0)
    jm = jmlp.ReplicationMLP(cfg)
    init = jax.tree.map(np.asarray, jm.params)
    # JAX's trajectory, one hand-rolled Adam epoch at a time
    x = np.asarray(feats, np.float32)
    scale = np.where(x.std(0) < 1e-9, 1.0, x.std(0))
    xj = jnp.asarray((x - x.mean(0)) / scale)
    yj = jax.nn.one_hot(jnp.asarray(y, jnp.int32) - 1, cfg.n_classes)
    params = jm.params
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    t = jnp.zeros((), jnp.int32)
    jlosses = []
    for _ in range(20):
        jlosses.append(float(jmlp._loss(params, xj, yj)))
        params, m, v, t = jmlp._adam_epoch(params, m, v, t, xj, yj,
                                           lr=cfg.lr)
    jloss = jm.fit(feats, y)

    tm = tmlp.ReplicationMLP(tmlp.MLPConfig(**dataclasses.asdict(cfg)),
                             device="cpu")
    tm.load(tmlp.params_from_jax(init, device="cpu"))
    tloss = tm.fit(feats, y)
    assert len(tm.losses) == cfg.epochs
    np.testing.assert_allclose(tm.losses[:20], jlosses, rtol=0,
                               atol=MLP_LOSS_TOL)
    assert abs(tloss - jloss) <= MLP_LOSS_TOL
    jlogits = np.asarray(jmlp._logits(jm.params, xj))
    np.testing.assert_allclose(tm.logits(feats), jlogits, rtol=0,
                               atol=MLP_LOGIT_TOL)
    top2 = np.sort(jlogits, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * MLP_LOGIT_TOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tm.predict(feats)[clear],
                                  jm.predict(feats)[clear])


def test_mlp_learns_the_clustering_policy_from_its_own_init():
    """The port's generator init, as ``test_core_extensions`` holds JAX's."""
    twf, tenv = _setup(T, "montage", 300, 1)
    p = T.plan(twf, tenv, device="cpu")
    feats = T.task_features(twf, tenv)
    cfg = T.MLPConfig(n_features=feats.shape[1],
                      n_classes=int(p.rep_counts.max()), epochs=400, seed=0)
    a = T.ReplicationMLP(cfg, device="cpu")
    b = T.ReplicationMLP(cfg, device="cpu")
    for pa, pb in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(pa, pb)       # the seed fixes the init
    assert np.isfinite(a.fit(feats, p.rep_counts))
    assert a.accuracy(feats, p.rep_counts) > 0.85
    assert a.losses[-1] < a.losses[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.schedule", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_launch_schedule_cpu_matches_the_example():
    out = _launch("--workflow", "ligo", "--size", "100", "--env",
                  "unstable", "--runs", "4", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout
    assert "device=cpu" in text and "plan phases (host s):" in text
    ex = subprocess.run(
        [sys.executable, "examples/schedule_workflow.py", "--workflow",
         "ligo", "--size", "100", "--env", "unstable", "--runs", "4"],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True,
        timeout=300)
    assert ex.returncode == 0, ex.stderr[-4000:]
    # the same table, row for row (the rep counts of ligo-100 seed 1 are
    # equal in both packages)
    table = ex.stdout.splitlines()[-4:]
    assert table[0].split()[0] == "algo"
    assert text.splitlines()[-4:] == table


def test_launch_schedule_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher runs on it")
    out = _launch("--size", "50")
    assert out.returncode != 0
    assert "pass --device cpu" in out.stderr
