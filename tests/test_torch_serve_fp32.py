"""The engine's cache storage in fp32 compute, on the CPU.

The serve engine keeps its batched cache in bf16 whatever the compute
dtype (``lm.init_cache``), as the JAX package's engine does, while
``greedy_decode``'s prefill keeps the compute dtype, as JAX's prefill does.
So the engine served in fp32 and the fp32 greedy reference differ by that
storage; ``greedy_decode(..., cache_dtypes=...)`` stores its cache as the
engine does, which the card's fp32 serve parity (``chip_smoke.py``'s
``fp32_parity``) uses for its like-for-like comparison.
"""
import dataclasses

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models import lm  # noqa: E402


@pytest.fixture(scope="module")
def fp32_olmo():
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu", cast=True)
    reqs = make_requests(tcfg, 4, 24, 12, 3)
    cache_len = max(serve.prompt_bucket(r.prompt_len) + r.max_new_tokens
                    for r in reqs)
    engine = serve.ServeEngine(
        tcfg, serve.EngineConfig(cache_len=cache_len),
        pool=serve.WorkerPool(2, 2, seed=0),
        policy=serve.crch_policy(reqs, device="cpu"), params=params,
        device="cpu")
    for r in reqs:
        engine.submit(r)
    engine.run(max_steps=2_000)
    return tcfg, params, reqs, cache_len, engine


def test_engine_stores_its_cache_in_bf16_in_fp32_compute_as_jax():
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    jcache = jlm.init_cache(jcfg, 4, 32)
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    tcache = lm.init_cache(tcfg, 4, 32, device="cpu")
    assert str(jcache["k"].dtype) == "bfloat16"
    assert tcache["k"].dtype == tcache["v"].dtype == torch.bfloat16
    jengine = jserve.ServeEngine(
        jcfg, jserve.EngineConfig(cache_len=32),
        pool=jserve.WorkerPool(1, 2, seed=0),
        params=jlm.init_params(jax.random.key(0), jcfg))
    assert str(jengine.cache["k"].dtype) == "bfloat16"


def test_greedy_decode_stores_its_cache_as_the_engine_does(fp32_olmo):
    """With the engine's cache dtypes the reference gives the engine's
    tokens; its logits differ from the fp32-cache reference's by the bf16
    storage alone (nonzero, within a few bf16 ulps of the logits)."""
    tcfg, params, reqs, cache_len, engine = fp32_olmo
    stored = {k: v.dtype for k, v in engine.cache.items()}
    assert stored["k"] == torch.bfloat16
    for r in reqs:
        like, like_logits = serve.greedy_decode(
            params, tcfg, r, cache_len, device="cpu", cache_dtypes=stored)
        assert like == engine.output(r.rid), r.rid
        plain, plain_logits = serve.greedy_decode(params, tcfg, r, cache_len,
                                                  device="cpu")
        n = min(len(like), len(plain))
        assert torch.equal(like_logits[0], plain_logits[0])  # the prefill
        diff = float((like_logits[1:n] - plain_logits[1:n]).abs().max())
        scale = float(plain_logits.abs().max())
        assert 0 < diff < 2 ** -6 * scale, (r.rid, diff, scale)


def test_greedy_decode_cache_dtypes_are_a_no_op_in_the_compute_dtype(
        fp32_olmo):
    tcfg, params, reqs, cache_len, _ = fp32_olmo
    r = reqs[0]
    fp32 = {k: torch.float32 for k in lm.init_cache(tcfg, 1, cache_len,
                                                    device="meta")}
    a, la = serve.greedy_decode(params, tcfg, r, cache_len, device="cpu",
                                cache_dtypes=fp32)
    b, lb = serve.greedy_decode(params, tcfg, r, cache_len, device="cpu")
    assert a == b and torch.equal(la, lb)
