"""The port's olmo model against the JAX package on the same weights:
attention, prefill, decode, greedy tokens, and the port's own init."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import greedy_reference as jax_greedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.serve import Request, greedy_reference  # noqa: E402

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", tiny=True),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, lm.params_from_jax(np_tree, tcfg, device="cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 256, (b, s)).astype(
        np.int32)


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_forward_causal_matches_jax(weights, dtype):
    """fp32 at 2e-4.  XLA on the CPU cannot run the bf16 x bf16 -> fp32
    products of the JAX function, so the port's bf16 run is held at the
    bf16 tolerance against the JAX function in fp32 on the same
    bf16-rounded inputs and weights."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(dtype)
    x = np.random.default_rng(1).normal(size=(2, 24, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    if dtype == "bfloat16":
        x = _bf16_round(x)
        jp = jax.tree.map(_bf16_round, jp)
        jcfg = _cfgs("float32")[0]
    want, (jk, jv) = jlayers.attention_forward(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        mode="causal", return_kv=True)
    got, (tk, tv) = layers.attention_forward(
        tp, torch.from_numpy(x).to(TDT[dtype]), tcfg,
        positions=torch.from_numpy(pos.copy()), mode="causal",
        return_kv=True)
    assert got.dtype == TDT[dtype]
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL[dtype])


@pytest.mark.parametrize("with_last_idx", [False, True])
def test_prefill_logits_and_cache_match_jax(weights, with_last_idx):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, 16, seed=2)
    last = np.asarray([9, 15], np.int32)
    jl, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 24,
                         last_idx=jnp.asarray(last) if with_last_idx
                         else None)
    tl, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        24, last_idx=torch.from_numpy(last)
                        if with_last_idx else None)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 256)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                   **TOL["float32"])


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_jax(weights, per_row):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(3, 12, seed=3)
    _, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 20)
    _, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, 20)
    nxt = _tokens(3, 1, seed=4)
    pos = np.asarray([12, 7, 10], np.int32) if per_row else 12
    jpos = jnp.asarray(pos) if per_row else jnp.int32(pos)
    tpos = torch.from_numpy(pos) if per_row else pos
    for _ in range(2):   # two steps: the second reads the first's write
        jl, jc = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jpos)
        tl, tc = lm.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                tpos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
        np.testing.assert_allclose(_f32(tc["k"]), _f32(jc["k"]),
                                   **TOL["float32"])
        jpos, tpos = jpos + 1, tpos + 1


def test_greedy_tokens_identical_in_fp32(weights):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (7, 12)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=16)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=16)
             for i, p in enumerate(prompts)]
    want = jax_greedy(jparams, jcfg, jreqs, 32)
    got = greedy_reference(tparams, tcfg, treqs, 32, device="cpu")
    for r in treqs:
        assert len(got[r.rid]) == 16
        assert got[r.rid] == want[r.rid], r.rid


def test_init_params_matches_jax_shapes_and_scales():
    jcfg, tcfg = _cfgs()
    jshapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    tparams = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jshapes)[0])
    tflat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = v

    walk(tparams, ())
    assert {tuple(p.key for p in k) for k in jflat} == set(tflat)
    # std of a standard normal truncated to [-2, 2]
    z = 2 / math.sqrt(2 * math.pi) * math.exp(-2)
    trunc = math.sqrt(1 - 2 * z / math.erf(2 / math.sqrt(2)))
    for path, spec in jflat.items():
        t = tflat[tuple(p.key for p in path)]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        fan_in = t.shape[-1] if path[-1].key == "embed" else t.shape[-2]
        want = trunc / math.sqrt(fan_in)
        assert abs(float(t.std()) / want - 1) < 0.05, path
