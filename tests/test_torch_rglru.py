"""The port's RecurrentGemma (RG-LRU + local attention hybrid) against the
JAX package on the same weights: the recurrent block (prefill and decode),
local attention in prefill and over the rolling decode ring, prefill,
decode and the parameter cast.  The leaves the JAX model reads in fp32
(gate biases, Lambda, norm scales) get seeded noise first, since their
initial values are constants that would hide a misuse."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from test_torch_rwkv import perturb_fp32_read  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
ARCH = "recurrentgemma-2b"
WINDOW = 16   # the tiny config's


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_config(ARCH, tiny=True),
                                compute_dtype=dtype),
            dataclasses.replace(get_config(ARCH, tiny=True),
                                compute_dtype=dtype))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    np_tree = perturb_fp32_read(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.key(0), jcfg)), seed=1)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return jparams, lm.params_from_jax(np_tree, tcfg, device="cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 256, (b, s)).astype(
        np.int32)


def _rec0(jparams, tparams):
    return (jax.tree.map(lambda a: a[0, 0], jparams["super"]["rec"]["rec"]),
            {k: v[0, 0] for k, v in tparams["super"]["rec"]["rec"].items()})


def test_layout_matches_jax(weights):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    assert lm.hybrid_layout(tcfg) == jlm.hybrid_layout(jcfg) == (1, 2)
    jflat = {tuple(p.key for p in path): a.shape for path, a in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = tuple(v.shape)

    walk(tparams, ())
    assert tflat == jflat
    cache = lm.init_cache(tcfg, 3, 40, device="meta")
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, 40))
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    state = rg.init_rglru_state(tcfg, 3, device="cpu")
    jstate = jrg.init_rglru_state(jcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in state.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jstate.items()}


@pytest.mark.parametrize("s", [5, 21])
def test_rglru_block_forward_matches_jax(weights, s):
    """Output and the decode carry (fp32 h, conv tail); S = 5 < the
    conv width's history is padded on the left."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    jp, tp = _rec0(jparams, tparams)
    x = np.random.default_rng(2).normal(size=(2, s, 64)).astype(np.float32)
    want, jst = jrg.rglru_block_forward(jp, jnp.asarray(x), jcfg,
                                        return_state=True)
    got, tst = rg.rglru_block_forward(tp, torch.from_numpy(x), tcfg,
                                      return_state=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert tst["h"].dtype == torch.float32
    for name in ("h", "conv"):
        assert tuple(tst[name].shape) == jst[name].shape
        np.testing.assert_allclose(_f32(tst[name]), _f32(jst[name]), **TOL)


def test_rglru_block_decode_matches_jax(weights):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    jp, tp = _rec0(jparams, tparams)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    st = {"h": rng.normal(size=(3, 64)).astype(np.float32),
          "conv": rng.normal(size=(3, 3, 64)).astype(np.float32)}
    want, jst = jrg.rglru_block_decode(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, jcfg)
    got, tst = rg.rglru_block_decode(
        tp, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()}, tcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_f32(tst[name]), _f32(jst[name]), **TOL)


@pytest.mark.parametrize("s", [12, 40])
def test_local_attention_forward_matches_jax(weights, s):
    """mode="local" on the windowed attention; S = 40 > window 16, so the
    window mask binds."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["attn"]["attn"])
    tp = {k: v[0] for k, v in tparams["super"]["attn"]["attn"].items()}
    x = np.random.default_rng(4).normal(size=(2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))
    want, (jk, jv) = jlayers.attention_forward(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), mode="local",
        window=WINDOW, return_kv=True)
    got, (tk, tv) = layers.attention_forward(
        tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos.copy()),
        mode="local", window=WINDOW, return_kv=True)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


@pytest.mark.parametrize("s", [12, 37])
def test_prefill_logits_and_cache_match_jax(weights, s):
    """S = 37 > window 16: the ring holds the last 16 keys at p % 16."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, s, seed=5)
    jl, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 48)
    tl, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        48)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert set(tc) == set(jc)
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_jax_across_the_ring_wrap(weights, per_row):
    """Decode ten steps from positions below the window; the ring slot
    (pos % 16) wraps past the window's end for every row but the one that
    starts at 3."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs()
    toks = _tokens(3, 10, seed=6)
    _, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 48)
    _, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, 48)
    pos = np.asarray([10, 3, 14], np.int32) if per_row else 10
    jpos = jnp.asarray(pos) if per_row else jnp.int32(pos)
    tpos = torch.from_numpy(pos) if per_row else pos
    nxt = _tokens(3, 1, seed=7)
    for step in range(10):
        jl, jc = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jpos)
        tl, tc = lm.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                tpos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
        for name in tc:
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       **TOL)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jpos, tpos = jpos + 1, tpos + 1


def test_cast_params_keeps_the_fp32_read_leaves(weights):
    _, tparams = weights
    _, tcfg = _cfgs("bfloat16")
    cast = lm.cast_params(tparams, tcfg)
    rec, src = cast["super"]["rec"]["rec"], tparams["super"]["rec"]["rec"]
    for name, leaf in rec.items():
        if name in ("ba", "bx", "lam"):
            assert leaf.dtype == torch.float32
            assert torch.equal(leaf, src[name])
        else:
            assert leaf.dtype == torch.bfloat16
    for norm in (cast["final_norm"], cast["super"]["attn"]["ln1"],
                 cast["tail"]["ln2"]):
        assert norm["scale"].dtype == torch.float32
    assert cast["embed"].dtype == torch.bfloat16
