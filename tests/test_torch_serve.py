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
