"""The port's RWKV-6 model against the JAX package on the same weights:
time mixing and channel mixing (prefill and decode), prefill, decode and
the parameter cast.  The leaves the JAX model reads in fp32 (decay base,
bonus, group-norm and layer-norm scales) get seeded noise first, since
their initial values are constants that would hide a misuse."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import rwkv6 as rw  # noqa: E402

# fp32: summation order only (the port's prefill runs the sequential WKV6
# recurrence, the JAX model its chunked form)
TOL = dict(atol=2e-4, rtol=2e-4)
ARCH = "rwkv6-3b"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_config(ARCH, tiny=True),
                                compute_dtype=dtype),
            dataclasses.replace(get_config(ARCH, tiny=True),
                                compute_dtype=dtype))


def perturb_fp32_read(np_tree, seed=0, scale=0.3):
    """Seeded noise on every leaf of ``lm.FP32_READ`` (numpy tree)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in lm.FP32_READ:
                out[k] = (v + scale * rng.normal(size=v.shape)).astype(
                    v.dtype)
            else:
                out[k] = v
        return out

    return walk(np_tree)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    np_tree = perturb_fp32_read(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.key(0), jcfg)))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return jparams, lm.params_from_jax(np_tree, tcfg, device="cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 256, (b, s)).astype(
        np.int32)


def _layer0(jparams, tparams, name):
    return (jax.tree.map(lambda a: a[0], jparams["layers"][name]),
            {k: v[0] for k, v in tparams["layers"][name].items()})


@pytest.mark.parametrize("s", [16, 21])
def test_time_mix_forward_matches_jax(weights, s):
    """Output, final state and last input; S = 21 is not a multiple of the
    JAX model's 16-token chunk, so its tail path is compared too."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    jp, tp = _layer0(jparams, tparams, "tm")
    x = np.random.default_rng(1).normal(size=(2, s, 128)).astype(np.float32)
    prev = np.zeros((2, 128), np.float32)
    want, (jS, jlast) = jrw.time_mix_forward(jp, jnp.asarray(x),
                                             jnp.asarray(prev), jcfg)
    got, (tS, tlast) = rw.time_mix_forward(tp, torch.from_numpy(x),
                                           torch.from_numpy(prev), tcfg)
    assert tS.dtype == torch.float32 and tuple(tS.shape) == (2, 2, 64, 64)
    for g, w in ((got, want), (tS, jS), (tlast, jlast)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_time_and_channel_mix_decode_match_jax(weights):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, 128)).astype(np.float32)
    S = (0.5 * rng.normal(size=(3, 2, 64, 64))).astype(np.float32)
    last = rng.normal(size=(3, 128)).astype(np.float32)
    jp, tp = _layer0(jparams, tparams, "tm")
    want, (jS, jl) = jrw.time_mix_decode(
        jp, jnp.asarray(x), (jnp.asarray(S), jnp.asarray(last)), jcfg)
    got, (tS, tl) = rw.time_mix_decode(
        tp, torch.from_numpy(x), (torch.from_numpy(S),
                                  torch.from_numpy(last)), tcfg)
    for g, w in ((got, want), (tS, jS), (tl, jl)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    jp, tp = _layer0(jparams, tparams, "cm")
    want, jl = jrw.channel_mix_decode(jp, jnp.asarray(x), jnp.asarray(last))
    got, tl = rw.channel_mix_decode(tp, torch.from_numpy(x),
                                    torch.from_numpy(last))
    for g, w in ((got, want), (tl, jl)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    xs = rng.normal(size=(2, 9, 128)).astype(np.float32)
    want, jl = jrw.channel_mix_forward(jp, jnp.asarray(xs),
                                       jnp.asarray(last[:2]))
    got, tl = rw.channel_mix_forward(tp, torch.from_numpy(xs),
                                     torch.from_numpy(last[:2]))
    for g, w in ((got, want), (tl, jl)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


@pytest.mark.parametrize("s", [16, 23])
def test_prefill_logits_and_cache_match_jax(weights, s):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, s, seed=3)
    jl, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 40)
    tl, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        40)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 256)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert set(tc) == set(jc) == {"S", "x_tm", "x_cm"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_jax(weights, per_row):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(3, 12, seed=4)
    _, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 20)
    _, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, 20)
    nxt = _tokens(3, 1, seed=5)
    pos = np.asarray([12, 7, 10], np.int32) if per_row else 12
    jpos = jnp.asarray(pos) if per_row else jnp.int32(pos)
    tpos = torch.from_numpy(pos) if per_row else pos
    for _ in range(2):   # two steps: the second reads the first's state
        jl, jc = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jpos)
        tl, tc = lm.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                tpos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
        for name in tc:
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       **TOL)
        jpos, tpos = jpos + 1, tpos + 1


def test_cast_params_keeps_the_fp32_read_leaves(weights):
    """In bf16 compute, the leaves JAX reads in fp32 stay fp32 bit for bit
    and every other leaf is rounded to bf16."""
    _, tparams = weights
    _, tcfg = _cfgs("bfloat16")
    cast = lm.cast_params(tparams, tcfg)
    seen = set()
    for name, leaf in cast["layers"]["tm"].items():
        src = tparams["layers"]["tm"][name]
        if name in lm.FP32_READ:
            seen.add(name)
            assert leaf.dtype == torch.float32 and torch.equal(leaf, src)
        else:
            assert leaf.dtype == torch.bfloat16
            assert torch.equal(leaf, src.to(torch.bfloat16))
    assert seen == {"ww", "u", "ln_scale"}
    assert cast["ln_in"]["scale"].dtype == torch.float32
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32
    assert cast["embed"].dtype == cast["lm_head"].dtype == torch.bfloat16


def test_time_mix_in_bf16_matches_jax_on_rounded_weights(weights):
    """The port's bf16 time mixing on cast params against JAX in fp32 on
    the same bf16-rounded input and the same rounding of exactly the leaves
    JAX casts (XLA on the CPU cannot run the JAX model's bf16 products);
    bf16 tolerance, as the olmo attention test."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs("bfloat16")
    jcfg = _cfgs("float32")[0]
    jp, _ = _layer0(jparams, tparams, "tm")
    jp = {k: v if k in lm.FP32_READ else
          jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)
          for k, v in jp.items()}
    tp = {k: v[0] for k, v in
          lm.cast_params(tparams, tcfg)["layers"]["tm"].items()}
    x = np.random.default_rng(6).normal(size=(1, 19, 128)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    zero = np.zeros((1, 128), np.float32)
    want, (jS, _) = jrw.time_mix_forward(jp, jnp.asarray(x),
                                         jnp.asarray(zero), jcfg)
    got, (tS, _) = rw.time_mix_forward(
        tp, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(zero).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16 and tS.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_f32(tS), _f32(jS), atol=5e-2, rtol=5e-2)
