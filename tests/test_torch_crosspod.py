"""The port's partition-tolerant cross-pod cluster against the JAX package:
``tests/test_crosspod.py``'s cases on the port (quorum election, tie park,
minority catch-up bit-identity, residual hygiene on membership change), the
int8 compression bit for bit against JAX's, ``tree_digest``'s hex, an
exchange round's average, the CI partition-heal command's report against
JAX's ``PodTrainingCluster`` on the same params, trace and batches, and the
launcher's command line end to end.

Losses are held at fp32 atol=rtol=2e-4 (the JAX kernel tests' limit);
counts, bits and digests exactly.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.ft import PodGradientExchange as JExchange  # noqa: E402
from repro.ft import PodTrainingCluster as JCluster  # noqa: E402
from repro.ft import tree_digest as jtree_digest  # noqa: E402
from repro.ft.crosspod import ClusterReport as JReport  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro_torch.chaos import (NET_PARTITION, ChaosEngine,  # noqa: E402
                               FaultEvent, FaultTrace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.ft import (CheckpointStore, ClusterReport,  # noqa: E402
                            PodGradientExchange, PodTrainingCluster,
                            tree_digest, tree_digests)
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import (compress_int8,  # noqa: E402
                               compress_tree_with_feedback, decompress_int8,
                               decompress_tree)
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-4, rtol=2e-4)
# the CI partition-heal command (.github/workflows/ci.yml) on the CPU
CI_ARGS = ["--arch", "olmo-1b", "--tiny", "--pods", "3", "--steps", "12",
           "--global-batch", "2", "--seq-len", "32", "--chaos", "unstable",
           "--chaos-seed", "29", "--chaos-assert", "--device", "cpu"]


def _grad(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(
        rng.standard_normal((16, 16)).astype(np.float32))}


def _np(t):
    """A port leaf as numpy (bf16 through its 2-byte pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def cluster_setup():
    cfg = get_config("olmo_1b", tiny=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _make_cluster(cfg, params, tmpdir, *, chaos=None, n_pods=3):
    return PodTrainingCluster(
        cfg=cfg, params=params,
        pipeline=SyntheticTokenPipeline(DataConfig(2, 32, seed=0), cfg),
        store=CheckpointStore(str(tmpdir)), n_pods=n_pods, ckpt_every=3,
        chaos=chaos)


# ---------------------------------------------------------------------------
# quorum election over the link matrix
# ---------------------------------------------------------------------------
def test_quorum_election_3_pods_minority_cut():
    ex = PodGradientExchange(n_pods=3)
    assert ex.current_quorum() == (0, 1, 2)
    ex.partition({2})
    assert ex.components() == [(0, 1), (2,)]
    assert ex.current_quorum() == (0, 1)
    res = ex.round([_grad(), _grad(), None])   # parked pod's grads unread
    assert res.quorum == (0, 1) and res.parked == (2,)
    assert res.avg is not None and res.fingerprint


def test_quorum_election_4_pods():
    ex = PodGradientExchange(n_pods=4)
    ex.partition({3})
    assert ex.current_quorum() == (0, 1, 2)    # 3 of 4 is a strict majority
    ex.partition({2})                           # now 2 of 4: a tie
    assert ex.current_quorum() is None
    ex.restore_pods({2})
    assert ex.current_quorum() == (0, 1, 2)


def test_no_majority_tie_parks_whole_cluster():
    ex = PodGradientExchange(n_pods=2)
    ex.partition({1})                           # 1 of 2 each side: no quorum
    res = ex.round([_grad(), _grad(1)])
    assert res.avg is None and res.fingerprint is None
    assert res.quorum == () and res.parked == (0, 1)
    assert ex.parked_pod_rounds == 2
    with pytest.raises(RuntimeError, match="no quorum"):
        ex.exchange([_grad(), _grad(1)])
    ex.restore_pods({1})                        # heal: full cluster again
    assert ex.current_quorum() == (0, 1)


def test_split_brain_fingerprint_detection():
    ex = PodGradientExchange(n_pods=3)
    assert ex.check_round_fingerprints(0, {0: "aa", 1: "aa", 2: "aa"})
    assert ex.split_brain_divergences == 0
    assert not ex.check_round_fingerprints(1, {0: "aa", 1: "bb"})
    assert ex.split_brain_divergences == 1


# ---------------------------------------------------------------------------
# residual hygiene on membership change
# ---------------------------------------------------------------------------
def test_rejoining_pod_adopts_quorum_residual_not_stale_one():
    ex = PodGradientExchange(n_pods=3)
    g = _grad()
    ex.round([g, g, g])                        # all residuals now nonzero
    stale = ex.residuals[2]
    assert any(leaf.abs().max() > 0 for _, leaf in flatten(stale))
    ex.partition({2})
    ex.round([g, g, None])                     # quorum residuals advance
    ex.round([g, g, None])
    assert tree_digest(ex.residuals[2]) == tree_digest(stale)  # frozen
    ex.restore_pods({2})
    # membership change: stale residual is reset, quorum's adopted
    ex.reset_residual(2)
    assert all(leaf.abs().max() == 0 for _, leaf in flatten(ex.residuals[2]))
    ex.set_residual(2, ex.residuals[0])
    assert tree_digest(ex.residuals[2]) == tree_digest(ex.residuals[0])
    assert tree_digest(ex.residuals[2]) != tree_digest(stale)


# ---------------------------------------------------------------------------
# minority catch-up: bit-identical to the unpartitioned run after heal
# ---------------------------------------------------------------------------
def test_partitioned_then_healed_matches_fault_free_run(tmp_path,
                                                        cluster_setup):
    cfg, params = cluster_setup
    init_digest = tree_digest(params)
    n_steps = 8
    trace = FaultTrace(events=[FaultEvent(step=2, kind=NET_PARTITION,
                                          targets=(2,), duration=3, seed=0)])
    faulty = _make_cluster(cfg, params, tmp_path / "a",
                           chaos=ChaosEngine(trace))
    rep = faulty.run(n_steps)
    clean = _make_cluster(cfg, params, tmp_path / "b")
    ref = clean.run(n_steps)

    assert rep.steps_completed == ref.steps_completed == n_steps
    assert rep.partitions == 1 and rep.heals == 1 and rep.catchups == 1
    assert rep.parked_pod_rounds > 0
    assert rep.split_brain_divergences == 0
    assert rep.index_violations == 0
    # every pod (including the healed minority pod 2) lands bit-identical
    # to the fault-free cluster
    ref_digest = tree_digest(clean.params[0])
    for p in range(3):
        assert tree_digest(faulty.params[p]) == ref_digest, f"pod {p}"
    # healed pod adopted the quorum's residual, not its stale one
    assert (tree_digest(faulty.exchange.residuals[2]) ==
            tree_digest(faulty.exchange.residuals[0]))
    np.testing.assert_allclose(rep.losses, ref.losses)
    # the pods' shared initial tensors were never written
    assert tree_digest(params) == init_digest


def test_heal_after_target_step_catches_lowest_index_pod_up(tmp_path,
                                                            cluster_setup):
    """Pod 0 is partitioned and the window outlives the run, so the heal
    drains at loop exit.  The catch-up commit must be authored by an
    up-to-date quorum member — never the rejoined stale pod, even when it
    has the lowest index."""
    cfg, params = cluster_setup
    trace = FaultTrace(events=[FaultEvent(step=3, kind=NET_PARTITION,
                                          targets=(0,), duration=50,
                                          seed=0)])
    faulty = _make_cluster(cfg, params, tmp_path / "a",
                           chaos=ChaosEngine(trace))
    rep = faulty.run(6)
    clean = _make_cluster(cfg, params, tmp_path / "b")
    clean.run(6)
    assert rep.steps_completed == 6
    assert rep.heals == 1 and rep.catchups == 1   # drained at loop exit
    ref_digest = tree_digest(clean.params[0])
    for p in range(3):
        assert tree_digest(faulty.params[p]) == ref_digest, f"pod {p}"


def test_whole_cluster_park_loses_rounds_not_batches(tmp_path,
                                                     cluster_setup):
    """Partitioning both non-lead pods of 3 leaves no majority: everyone
    parks for the window, then training resumes on the *next* batch —
    wall-clock rounds are lost, data order is not."""
    cfg, params = cluster_setup
    trace = FaultTrace(events=[FaultEvent(step=1, kind=NET_PARTITION,
                                          targets=(1, 2), duration=2,
                                          seed=0)])
    cluster = _make_cluster(cfg, params, tmp_path / "a",
                            chaos=ChaosEngine(trace))
    rep = cluster.run(4)
    clean = _make_cluster(cfg, params, tmp_path / "b")
    ref = clean.run(4)
    assert rep.steps_completed == 4
    assert rep.rounds > ref.rounds          # parked rounds consumed wall clock
    assert rep.split_brain_divergences == 0
    ref_digest = tree_digest(clean.params[0])
    assert all(tree_digest(cluster.params[p]) == ref_digest
               for p in range(3))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _compression_input(case):
    rng = np.random.default_rng(7)
    if case == "zero":
        return np.zeros((5, 3), np.float32)
    if case == "half_quanta":
        # max |g| = 127 gives scale 1 exactly: each value sits on a .5
        return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                        np.float32)
    return (rng.standard_normal((33, 17)) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("case,dtype", [("normal", "float32"),
                                        ("normal", "bfloat16"),
                                        ("zero", "float32"),
                                        ("half_quanta", "float32")])
def test_compression_is_bit_exact_against_jax(case, dtype):
    g = _compression_input(case)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    assert np.array_equal(_np(tg), np.asarray(jg))
    jq, js = jgc.compress_int8(jg)
    tq, ts = compress_int8(tg)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert (decompress_int8(tq, ts).numpy().tobytes()
            == np.asarray(jgc.decompress_int8(jq, js)).tobytes())
    if case == "half_quanta":   # round half to even, as jnp.round
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    # the tree form with a residual carried in
    r = np.random.default_rng(3).standard_normal(g.shape).astype(
        np.float32) * 1e-4
    jtree = {"a": {"w": jg}, "b": jnp.asarray(g[::-1].copy())}
    ttree = {"a": {"w": tg}, "b": torch.from_numpy(g[::-1].copy())}
    jres = {"a": {"w": jnp.asarray(r)}, "b": jnp.asarray(r)}
    tres = {"a": {"w": torch.from_numpy(r)}, "b": torch.from_numpy(r)}
    got = compress_tree_with_feedback(ttree, tres)
    want = jgc.compress_tree_with_feedback(jtree, jres)
    for gt, wt in zip(got, want):
        gl = [t.numpy() for _, t in flatten(gt)]
        wl = [np.asarray(x) for x in jax.tree.leaves(wt)]
        assert [x.tobytes() for x in gl] == [x.tobytes() for x in wl]
    assert (tree_digest(decompress_tree(*got[:2]))
            == jtree_digest(jgc.decompress_tree(*want[:2])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_digest_equals_jax_hex(dtype):
    jcfg = jax_get_config("olmo-1b", tiny=True)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    jparams = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    tparams = lm.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 get_config("olmo-1b", tiny=True),
                                 device="cpu")
    assert tree_digest(tparams) == jtree_digest(jparams)
    # a thread a tree, as the cluster takes its pods' fingerprints
    half = {"embed": tparams["embed"]}
    assert tree_digests([tparams, half, tparams]) == [
        tree_digest(tparams), tree_digest(half), tree_digest(tparams)]


@pytest.mark.parametrize("same", [True, False])
def test_exchange_round_matches_jax(same):
    """The replicated-agreement fast path (three equal gradients) and the
    averaging path (three that differ) give JAX's average and fingerprint,
    bit for bit, over two rounds (the second with the residual fed back),
    and the same byte counts."""
    seeds = [0, 0, 0] if same else [0, 1, 2]
    jex, tex = JExchange(3), PodGradientExchange(3)
    for rnd in range(2):
        grads = [{"w": np.random.default_rng(s + 10 * rnd).standard_normal(
            (16, 8)).astype(np.float32),
            "b": np.random.default_rng(s + 5).standard_normal(8).astype(
                np.float32)} for s in seeds]
        want = jex.round([jax.tree.map(jnp.asarray, g) for g in grads])
        got = tex.round([{k: torch.from_numpy(v) for k, v in g.items()}
                         for g in grads])
        assert got.fingerprint == want.fingerprint
        for k in ("w", "b"):
            assert (got.avg[k].numpy().tobytes()
                    == np.asarray(want.avg[k]).tobytes())
    assert (tex.bytes_sent_int8, tex.bytes_sent_fp32) == (
        jex.bytes_sent_int8, jex.bytes_sent_fp32)
    assert tex.compression_ratio == jex.compression_ratio == 4.0


def test_cluster_report_has_the_jax_fields():
    assert ([f.name for f in dataclasses.fields(ClusterReport)]
            == [f.name for f in dataclasses.fields(JReport)])


def test_ci_partition_heal_command_matches_jax_cluster(tmp_path):
    """The CI partition-heal command's code path (``cluster_main``) on
    JAX's init in fp32 against JAX's ``PodTrainingCluster`` built here
    without a mesh (the JAX launcher fails on this jax) on the same params,
    trace and batches: every integer field of the report equal, losses
    within the fp32 tolerance, and the launcher's --chaos-assert passes."""
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    args = launch.build_parser().parse_args(
        CI_ARGS + ["--ckpt-dir", str(tmp_path / "port")])
    got = launch.cluster_main(tcfg, args, params=lm.params_from_jax(
        np_params, tcfg, device="cpu"))
    rep = got["report"]
    trace = jchaos.sample_trace("unstable", horizon=12, n_targets=3,
                                seed=29, kinds=(jchaos.NET_PARTITION,
                                                jchaos.DISK_FULL))
    assert got["chaos"].trace.to_json() == trace.to_json()
    jcluster = JCluster(
        cfg=jcfg, params=jparams,
        pipeline=JPipeline(JDataConfig(2, 32, seed=0), jcfg),
        store=JStore(str(tmp_path / "jax")), n_pods=3,
        opt_cfg=JAdamWConfig(lr=3e-4), q_chunk=32, xent_chunk=512,
        chaos=jchaos.ChaosEngine(trace), fingerprint_every=1)
    want = jcluster.run(12)
    assert want.partitions == 1 and want.catchups == 1
    for f in dataclasses.fields(JReport):
        if f.name in ("losses", "final_loss"):
            continue
        assert getattr(rep, f.name) == getattr(want, f.name), f.name
    np.testing.assert_allclose(rep.losses, want.losses, **TOL)
    assert (got["cluster"].exchange.compression_ratio
            == jcluster.exchange.compression_ratio == 4.0)


def test_ci_command_end_to_end(tmp_path):
    """The CI command itself (bf16 compute on the CPU), traced, then the
    validator as CI runs it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    trace_dir = tmp_path / "trace"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CI_ARGS,
         "--trace-dir", str(trace_dir), "--trace-dump-on-fault"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(l.startswith("arch=olmo-tiny") and "pods=3" in l
               and "compression=4.0x" in l for l in lines)
    assert any(l.startswith("partitions 1 ") and "split-brain 0" in l
               for l in lines)
    assert any(l.startswith("chaos-assert OK: 12 steps") for l in lines)
    assert any(l.startswith("trace: ") for l in lines)
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", str(trace_dir),
         "--require-span", "crosspod.partition", "--require-span",
         "crosspod.heal", "--require-span", "crosspod.catchup",
         "--require-span", "recover.net_partition"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert val.returncode == 0, val.stdout + val.stderr
    assert "trace schema OK" in val.stdout
    # no GPU here: without --device cpu the launcher refuses to run
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *CI_ARGS[:-2]], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=120)
        assert bad.returncode != 0 and "CUDA is not available" in bad.stderr
