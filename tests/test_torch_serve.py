"""The port's CRCH serve path against the JAX package: PCA, the replication
policy, engine tokens under failures, idle-slot bit-identity, snapshots."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import pca as jpca  # noqa: E402
from repro.core.clustering import \
    triplet_agglomerate as jax_triplet  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import clustering, pca  # noqa: E402
from repro_torch.distributed.steps import make_serve_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.snapshot import (DecodeSnapshot, SnapshotStore,  # noqa: E402
                                        cache_batch_axes, slot_get)


def _requests(mod, n, seed, *, prompt_len=32, new_tokens=16, vocab=256):
    """The launchers' request mix, built with ``mod``'s Request class."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(prompt_len // 2, 4), prompt_len + 1))
        newt = new_tokens if i % 3 else new_tokens * 2
        reqs.append(mod.Request(
            rid=i, prompt=rng.integers(1, vocab, plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=newt, arrival=0, deadline=16 * (plen + newt)))
    return reqs


def test_fit_pca_matches_jax():
    """Same k and coverage; projections equal up to each component's sign
    (the SVD's sign is arbitrary), so compare magnitudes."""
    for seed in range(3):
        feats = serve.request_features(_requests(serve, 24, seed))
        got = pca.fit_pca(feats, 0.35, device="cpu")
        want = jpca.fit_pca(feats, 0.35)
        assert got.components.shape == want.components.shape
        np.testing.assert_allclose(got.cov, want.cov, rtol=1e-5)
        np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5)
        np.testing.assert_allclose(got.scale, want.scale, rtol=1e-5)
        np.testing.assert_allclose(np.abs(got.projected),
                                   np.abs(want.projected), atol=1e-4)


def test_crch_policy_classes_match_jax():
    """``by_class`` end to end on seeded request samples, and the clustering
    of both packages on one distance matrix (merge ties are argmins over
    float64 losses, so identical inputs must give identical labels)."""
    for seed in range(3):
        treqs = _requests(serve, 24, seed, prompt_len=64, new_tokens=32)
        jreqs = _requests(jserve, 24, seed, prompt_len=64, new_tokens=32)
        got = serve.crch_policy(treqs, device="cpu").by_class
        want = jserve.crch_policy(jreqs).by_class
        assert ({(c.prompt_bucket, c.new_bucket): r for c, r in got.items()}
                == {(c.prompt_bucket, c.new_bucket): r
                    for c, r in want.items()})
        pts = pca.fit_pca(serve.request_features(treqs), device="cpu"
                          ).projected
        a = clustering.triplet_agglomerate(pts, n_clusters=3, device="cpu")
        b = jax_triplet(pts, n_clusters=3)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert [m[:2] for m in a.merge_history] == \
            [m[:2] for m in b.merge_history]
        np.testing.assert_allclose([m[2] for m in a.merge_history],
                                   [m[2] for m in b.merge_history],
                                   atol=3e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def fp32_olmo():
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    tparams = lm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _cache_len(reqs):
    return max(serve.prompt_bucket(r.prompt_len) + r.max_new_tokens
               for r in reqs)


def test_engine_tokens_match_reference_and_jax_under_failures(fp32_olmo):
    jcfg, tcfg, jparams, tparams = fp32_olmo
    treqs, jreqs = _requests(serve, 6, 1), _requests(jserve, 6, 1)
    cache_len = _cache_len(treqs)
    tpool = serve.WorkerPool(2, 2, environment="unstable", seed=0)
    engine = serve.ServeEngine(
        tcfg, serve.EngineConfig(cache_len=cache_len), pool=tpool,
        policy=serve.crch_policy(treqs, device="cpu"), params=tparams,
        device="cpu")
    jengine = jserve.ServeEngine(
        jcfg, jserve.EngineConfig(cache_len=cache_len, q_chunk=64),
        pool=jserve.WorkerPool(2, 2, environment="unstable", seed=0),
        policy=jserve.crch_policy(jreqs), params=jparams)
    for tr, jr in zip(treqs, jreqs):
        engine.submit(tr)
        jengine.submit(jr)
    engine.run(max_steps=2_000)
    jengine.run(max_steps=2_000)
    m = engine.metrics
    assert len(engine.completed) == len(treqs)
    assert m.failures >= 1
    assert m.restores + m.resubmissions >= 1
    ref = serve.greedy_reference(tparams, tcfg, treqs, cache_len,
                                 device="cpu")
    for r in treqs:
        assert engine.output(r.rid) == ref[r.rid], r.rid
        assert engine.output(r.rid) == jengine.output(r.rid), r.rid


def test_idle_slot_row_bit_identical_through_masked_step(fp32_olmo):
    _, tcfg, _, tparams = fp32_olmo
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    params = lm.cast_params(tparams, tcfg)
    axes = cache_batch_axes(tcfg, 16)
    cache = lm.init_cache(tcfg, 3, 16, device="cpu")
    g = torch.Generator().manual_seed(0)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = slot_get(cache, axes, 1)
    live_before = slot_get(cache, axes, 0)
    step = make_serve_step(tcfg, cache_axes=axes)
    live = torch.tensor([True, False, True])
    for i in range(3):
        pos = torch.tensor([4 + i, 2, 9 + i])
        tok = torch.tensor([[3], [5], [7]])
        _, logits, cache = step(params, cache, tok, pos, live)
        assert torch.isfinite(logits).all()
    after = slot_get(cache, axes, 1)
    for name in before:
        assert torch.equal(before[name], after[name])
    # the live rows did take their writes
    assert not torch.equal(slot_get(cache, axes, 0)["k"][:, 4],
                           live_before["k"][:, 4])


def test_snapshot_roundtrip_verifies_and_corruption_fails():
    cfg = get_config("olmo-1b", tiny=True)
    axes = cache_batch_axes(cfg, 12)
    assert axes == {"k": lm.CACHE_BATCH_AXIS, "v": lm.CACHE_BATCH_AXIS}
    cache = lm.init_cache(cfg, 2, 12, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    cache["k"].normal_(generator=torch.Generator().manual_seed(1))
    row = slot_get(cache, axes, 1)
    store = SnapshotStore()
    snap = DecodeSnapshot(rid=7, pos=5, tokens=[1, 2], last_token=2,
                          cache_row=row, step=3)
    store.save(snap)
    assert store.verify(store.get(7))
    assert snap.nbytes() == 2 * row["k"].numel() * 2
    # the snapshot is a copy: later cache writes do not reach it
    cache["k"].zero_()
    assert store.verify(store.get(7))
    assert store.corrupt(seed=11) == 1
    assert not store.verify(store.get(7))


# ---------------------------------------------------------------------------
# the recurrent families: RWKV-6 (state on batch axis 1) and the RG-LRU
# hybrid (h/conv stacks on batch axis 2, a rolling K/V ring on axis 1)
# ---------------------------------------------------------------------------

RECURRENT = ("rwkv6-3b", "recurrentgemma-2b")


@pytest.fixture(scope="module", params=RECURRENT)
def fp32_recurrent(request):
    from test_torch_rwkv import perturb_fp32_read
    jcfg = dataclasses.replace(jax_get_config(request.param, tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(request.param, tiny=True),
                               compute_dtype="float32")
    np_tree = perturb_fp32_read(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.key(0), jcfg)), seed=2)
    return (jcfg, tcfg, jax.tree.map(jax.numpy.asarray, np_tree),
            lm.params_from_jax(np_tree, tcfg, device="cpu"))


def _recurrent_cache_len(cfg, reqs):
    # the engine refuses a cache shorter than the hybrid's rolling window
    return max(_cache_len(reqs), cfg.window if cfg.rglru else 0)


def test_recurrent_engine_tokens_match_reference_and_jax_under_failures(
        fp32_recurrent):
    """Exact-length prefill, failures, snapshot restores: greedy tokens
    equal to the port's batch=1 reference and to the JAX engine.  The
    tiny hybrid's prompts (16-32 tokens) exceed its 16-slot window."""
    jcfg, tcfg, jparams, tparams = fp32_recurrent
    treqs, jreqs = _requests(serve, 6, 1), _requests(jserve, 6, 1)
    cache_len = _recurrent_cache_len(tcfg, treqs)
    engine = serve.ServeEngine(
        tcfg, serve.EngineConfig(cache_len=cache_len),
        pool=serve.WorkerPool(2, 2, environment="unstable", seed=0),
        policy=serve.crch_policy(treqs, device="cpu"), params=tparams,
        device="cpu")
    jengine = jserve.ServeEngine(
        jcfg, jserve.EngineConfig(cache_len=cache_len, q_chunk=64),
        pool=jserve.WorkerPool(2, 2, environment="unstable", seed=0),
        policy=jserve.crch_policy(jreqs), params=jparams)
    prefill, seqs = engine._prefill_step, []

    def recording_prefill(params, batch, last_idx):
        seqs.append(batch["tokens"].shape[1])
        return prefill(params, batch, last_idx)

    engine._prefill_step = recording_prefill
    for tr, jr in zip(treqs, jreqs):
        engine.submit(tr)
        jengine.submit(jr)
    engine.run(max_steps=2_000)
    jengine.run(max_steps=2_000)
    m = engine.metrics
    assert len(engine.completed) == len(treqs)
    assert m.failures >= 1 and m.restores + m.resubmissions >= 1
    # exact-length prefill: every prompt went in unpadded
    assert set(seqs) <= {r.prompt_len for r in treqs}
    assert any(s != serve.prompt_bucket(s) for s in seqs)
    ref = serve.greedy_reference(tparams, tcfg, treqs, cache_len,
                                 device="cpu")
    for r in treqs:
        assert engine.output(r.rid) == ref[r.rid], r.rid
        assert engine.output(r.rid) == jengine.output(r.rid), r.rid


def test_recurrent_idle_slot_rows_bit_identical_through_masked_step(
        fp32_recurrent):
    """Every cache leaf, whatever its batch axis: an idle slot's row stays
    bit-identical through the masked step, and the live rows change."""
    _, tcfg, _, tparams = fp32_recurrent
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    params = lm.cast_params(tparams, tcfg)
    cache_len = max(16, tcfg.window)
    axes = cache_batch_axes(tcfg, cache_len)
    assert axes == lm.commit_axes(tcfg)
    cache = lm.init_cache(tcfg, 3, cache_len, device="cpu")
    g = torch.Generator().manual_seed(0)
    for leaf in cache.values():
        leaf.copy_(0.5 * torch.randn(leaf.shape, generator=g))
    before = slot_get(cache, axes, 1)
    live_before = slot_get(cache, axes, 0)
    step = make_serve_step(tcfg, cache_axes=axes)
    live = torch.tensor([True, False, True])
    for i in range(3):
        pos = torch.tensor([4 + i, 2, 19 + i])
        _, logits, cache = step(params, cache, torch.tensor([[3], [5], [7]]),
                                pos, live)
        assert torch.isfinite(logits).all()
    after = slot_get(cache, axes, 1)
    for name in before:
        assert torch.equal(before[name], after[name]), name
    live_after = slot_get(cache, axes, 0)
    state = "S" if tcfg.rwkv else "h"
    assert not torch.equal(live_after[state], live_before[state])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_snapshot_roundtrip_and_batch_axes(arch):
    """The probed batch axes are the JAX package's, a snapshot of one slot
    restores bit for bit into another, and corruption is caught."""
    import repro.serve.snapshot as jsnap
    cfg = get_config(arch, tiny=True)
    jcfg = jax_get_config(arch, tiny=True)
    axes = cache_batch_axes(cfg, 24)
    assert axes == jsnap.cache_batch_axes(jcfg, 24) == lm.commit_axes(cfg)
    cache = lm.init_cache(cfg, 2, 24, device="cpu")
    g = torch.Generator().manual_seed(3)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    store = SnapshotStore()
    store.save(DecodeSnapshot(rid=1, pos=9, tokens=[4], last_token=4,
                              cache_row=slot_get(cache, axes, 0), step=2))
    serve.snapshot.slot_set(cache, axes, 1, store.get(1).cache_row)
    for name, leaf in cache.items():
        assert torch.equal(leaf.select(axes[name], 0),
                           leaf.select(axes[name], 1)), name
    assert store.verify(store.get(1))
    assert store.corrupt(seed=5) == 1
    assert not store.verify(store.get(1))
