"""The decoder-only families of the port against the JAX package on the same
weights: deepseek-coder-33b, granite-20b (q/k/v/o biases, LayerNorm bias,
MQA), command-r-plus-104b (the parallel block), granite-moe-1b-a400m and
phi3.5-moe-42b-a6.6b (the GShard MoE layer).  Configs, ``moe_forward``
(output, aux loss, dropped pairs, top-k tie order, every gradient) at each
dispatch-group rule, the attention biases, the parallel block, each
family's prefill / decode logits and ``forward_train`` gradients, the init,
and the serve engine.

Tolerances: fp32 atol=rtol=2e-4 (the JAX kernel tests' limit); bf16 5e-2
against the JAX function in fp32 on the same bf16-rounded inputs and
weights (XLA on the CPU cannot run bf16 x bf16 -> fp32 products); keep
masks, chosen experts and tokens exactly.  The norm scales and biases and
the attention biases, which JAX initialises to ones and zeros, are
perturbed so that a missing or misplaced one shows.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import NOT_PORTED, get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
NEW = ("deepseek-coder-33b", "granite-20b", "command-r-plus-104b",
       "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
MOE = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
#: leaves JAX initialises to constants (norm scales and biases, attention
#: biases): perturbed in the tests
CONST_LEAVES = {"scale", "bias", "bq", "bk", "bv", "bo"}


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(arch, tiny=True),
                               compute_dtype="float32", **kw)
    return jcfg, tcfg


def _perturbed(np_tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
                if k in CONST_LEAVES else v
                for k, v in node.items()}

    return walk(np_tree)


_WEIGHTS = {}


def _weights(arch):
    """(JAX params, numpy tree, port params) of the tiny family in fp32,
    with the constant leaves perturbed."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch)
        np_tree = _perturbed(jax.tree.map(
            np.asarray, jlm.init_params(jax.random.key(0), jcfg)), seed=1)
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, np_tree), np_tree,
                          lm.params_from_jax(np_tree, tcfg, device="cpu"))
    return _WEIGHTS[arch]


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _tokens(b, s, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_config_equals_jax_field_by_field(arch, tiny):
    want = dataclasses.asdict(jax_get_config(arch, tiny=tiny))
    assert dataclasses.asdict(get_config(arch, tiny=tiny)) == want


def test_only_the_encoder_and_image_families_are_left():
    """None is left: every family of the JAX package is registered (the
    encoder-decoder and image families too), and an unknown arch still
    raises, naming the ten."""
    assert NOT_PORTED == ()
    for arch in ("whisper-small", "llava-next-mistral-7b"):
        assert get_config(arch).name == arch
    with pytest.raises(ValueError, match="not a known architecture") as err:
        get_config("no-such-model")
    assert all(name in str(err.value) for name in lm.TRAIN_FAMILIES)


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def _jax_keep(p, x, cfg):
    """JAX's keep mask, by the steps of ``repro.models.layers.moe_forward``
    (which does not return it): groups, top-k, capacity, positions."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if s >= jlayers.MOE_GROUP and s % jlayers.MOE_GROUP == 0:
        g_count, g = b * (s // jlayers.MOE_GROUP), jlayers.MOE_GROUP
    elif s == 1:
        g_count, g = 1, b
    else:
        g_count, g = b, s
    xt = x.reshape(g_count, g, d)
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
    _, gate_idx = jax.lax.top_k(probs, k)
    cap = max(int(math.ceil(g * k / e * cfg.capacity_factor)), 4)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(g_count, g * k, e)
    pos_in_e = (jnp.cumsum(flat, axis=1) - flat).reshape(g_count, g, k, e)
    pos = jnp.sum(pos_in_e * onehot, axis=-1)
    return np.asarray(pos < cap), np.asarray(gate_idx)


def _moe_check(arch, p_np, x, **kw):
    """The port's moe_forward against JAX's on ``p_np`` and ``x``: output,
    aux, keep mask, and the gradients of every param and of x under one
    cotangent of the output and one of aux."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jax.tree.map(jnp.asarray, p_np)
    (jo, ja), vjp = jax.vjp(lambda p, x: jlayers.moe_forward(p, x, jcfg),
                            jp, jnp.asarray(x))
    dout = np.random.default_rng(9).normal(size=jo.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(dout), jnp.float32(0.7)))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p_np.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    layers.route_log = []
    try:
        to, ta = layers.moe_forward(tp, tx, tcfg)
        (route,) = layers.route_log
        keep = route["keep"]
    finally:
        layers.route_log = None
    (to * torch.from_numpy(dout)).sum().add(0.7 * ta).backward()
    want_keep, want_idx = _jax_keep(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(_f32(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for name in p_np:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jgp[name]), err_msg=name,
                                   **TOL)
    return keep.numpy(), want_idx


def _moe_params(arch, seed=1):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.array,        # writable copies
                        jlayers.init_moe(jax.random.key(seed), jcfg))


# (b, s, capacity_factor): a 2048-token group, two groups per sequence, a
# decode step (one group across the batch), one group per sequence, and
# capacity drops at a low capacity factor
MOE_CASES = {"group_2048": (1, 2048, 1.25), "two_groups": (1, 4096, 1.25),
             "decode_batch": (3, 1, 1.25), "per_sequence": (2, 24, 1.25),
             "drops": (2, 24, 0.3)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax(arch, case):
    b, s, cf = MOE_CASES[case]
    x = np.random.default_rng(3).normal(size=(b, s, 64)).astype(np.float32)
    keep, _ = _moe_check(arch, _moe_params(arch), x, capacity_factor=cf)
    g = {"group_2048": 2048, "two_groups": 2048, "decode_batch": 3}.get(
        case, s)
    assert keep.shape[1] == g
    assert (~keep).sum() > 0 if case == "drops" else True


def test_moe_decode_group_keeps_idle_rows():
    """A decode step is one group across the batch: a row's tokens take
    capacity slots before the next row's, so a row that is idle in the
    engine still counts (the cap is 4 here, and 6 rows x 2 choices go
    to 4 experts)."""
    x = np.abs(np.random.default_rng(4).normal(size=(6, 1, 64))).astype(
        np.float32)
    p = _moe_params("granite-moe-1b-a400m")
    p["router"][:, 0] += 5.0      # every token's first choice: expert 0
    keep, idx = _moe_check("granite-moe-1b-a400m", p, x)
    assert (idx[0, :, 0] == 0).all() and keep.shape == (1, 6, 2)
    np.testing.assert_array_equal(keep[0, :, 0], [1, 1, 1, 1, 0, 0])


def test_top_k_orders_ties_by_index_as_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(5, 7, 16)).astype(np.float32) / 4
    for k in (1, 2, 8, 16):
        idx = layers.top_k_indices(torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jax.lax.top_k(x, k)[1]))


@pytest.mark.parametrize("arch", MOE)
def test_moe_tie_at_the_top_k_boundary_takes_the_lower_expert(arch):
    """Two equal router columns make experts 1 and 2 tie exactly for every
    token, at ranks 2 and 3 (expert 0 above, expert 3 below): JAX's top_k
    takes expert 1; so must the port, or its output would carry expert 2's
    weights."""
    p = _moe_params(arch)
    d = p["router"].shape[0]
    w = np.abs(np.random.default_rng(6).normal(size=d)).astype(np.float32)
    p["router"] = np.stack([3 * w, w, w, -w], axis=1) / d
    x = np.abs(np.random.default_rng(7).normal(size=(2, 24, d))).astype(
        np.float32)
    _, idx = _moe_check(arch, p, x)
    assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()


# ---------------------------------------------------------------------------
# attention biases and the parallel block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_with_biases_matches_jax(dtype):
    """granite-20b's q/k/v/o biases (before rope; after wo) under MQA
    (4 query heads on 1 KV head): the prefill attention with its K/V, then
    one decode step."""
    jparams, np_tree, _ = _weights("granite-20b")
    jcfg, tcfg = _cfgs("granite-20b")
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    p_np = {k: v[0] for k, v in np_tree["layers"]["attn"].items()}
    assert {"bq", "bk", "bv", "bo"} <= set(p_np)
    x = np.random.default_rng(1).normal(size=(2, 20, 64)).astype(np.float32)
    xd = np.random.default_rng(2).normal(size=(2, 1, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        x, xd = _bf16_round(x), _bf16_round(xd)
        p_np = {k: _bf16_round(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in p_np.items()}
    jp = jax.tree.map(jnp.asarray, p_np)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    want, (jk, jv) = jlayers.attention_forward(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), mode="causal",
        return_kv=True)
    got, (tk, tv) = layers.attention_forward(
        tp, torch.from_numpy(x).to(tdt), tcfg,
        positions=torch.from_numpy(pos.copy()), mode="causal",
        return_kv=True)
    tol = TOL if dtype == "float32" else BF16_TOL
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **tol)
    shape = (2, 24, *jk.shape[2:])
    cache = {"k": jnp.zeros(shape).at[:, :20].set(jk),
             "v": jnp.zeros(shape).at[:, :20].set(jv)}
    tcache = {"k": torch.zeros(shape, dtype=tdt),
              "v": torch.zeros(shape, dtype=tdt)}
    tcache["k"][:, :20], tcache["v"][:, :20] = tk, tv
    want, _ = jlayers.attention_decode(jp, jnp.asarray(xd), cache, jcfg,
                                       pos=jnp.int32(20))
    got = layers.attention_decode(tp, torch.from_numpy(xd).to(tdt), tcache,
                                  tcfg, pos=20)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parallel_block_matches_jax(dtype):
    """command-r-plus-104b's block: x + attn(h) + mlp(h), one LayerNorm
    without bias, no ln2."""
    jparams, np_tree, _ = _weights("command-r-plus-104b")
    jcfg, tcfg = _cfgs("command-r-plus-104b")
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    p_np = jax.tree.map(lambda a: a[0], np_tree["layers"])
    assert "ln2" not in p_np and "bias" not in p_np["ln1"]
    x = np.random.default_rng(3).normal(size=(2, 18, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        x = _bf16_round(x)
        p_np = jax.tree.map(_bf16_round, p_np)
    pos = np.broadcast_to(np.arange(18), (2, 18))
    want, jaux = jlm._dense_block(jax.tree.map(jnp.asarray, p_np),
                                  jnp.asarray(x), jcfg, jnp.asarray(pos))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p_np)
    tp = lm.cast_params(tp, tcfg)
    got, aux = lm._dense_block(tp, torch.from_numpy(x).to(tdt), tcfg,
                               torch.from_numpy(pos.copy()))
    assert got.dtype == tdt and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(TOL if dtype == "float32" else BF16_TOL))


# ---------------------------------------------------------------------------
# each family: prefill, decode, forward_train, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill with per-row last positions, then two decode steps at
    per-row positions (the second reads the first's cache write)."""
    jparams, _, tparams = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens(3, 16, 2, tcfg.vocab_size)
    last = np.asarray([9, 15, 12], np.int32)
    jl, jc = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 24,
                         last_idx=jnp.asarray(last))
    tl, tc = lm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        24, last_idx=torch.from_numpy(last))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), **TOL)
    nxt = _tokens(3, 1, 4, tcfg.vocab_size)
    pos = last + 1
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for _ in range(2):
        jl, jc = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jpos)
        tl, tc = lm.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                tpos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
        np.testing.assert_allclose(_f32(tc["k"]), _f32(jc["k"]), **TOL)
        jpos, tpos = jpos + 1, tpos + 1


def _batch(b, s, seed, vocab):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    tok = tok.astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", NEW)
def test_forward_train_loss_aux_and_every_gradient_match_jax(arch, remat):
    jparams, np_tree, _ = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    batch = _batch(2, 32, 7, tcfg.vocab_size)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jcfg, jax.tree.map(jnp.asarray, batch),
                                    xent_chunk=12), has_aux=True)(jparams)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    loss, m = lm.forward_train(unflatten(np_tree, leaves),
                               dataclasses.replace(tcfg, remat=remat),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, xent_chunk=12)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), **TOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **TOL)
    assert (float(m["aux"]) > 0) == (arch in MOE)
    for (name, _), (_, jg), leaf in zip(flatten(np_tree), flatten(
            jax.tree.map(np.asarray, jgrads)), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, err_msg=str(name),
                                   **TOL)


@pytest.mark.parametrize("arch", NEW)
def test_init_params_matches_jax_shapes_and_scales(arch):
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    tparams = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    jflat = {tuple(p.key for p in path): spec for path, spec in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    tflat = dict(flatten(tparams))
    assert set(jflat) == set(tflat)
    z = 2 / math.sqrt(2 * math.pi) * math.exp(-2)
    trunc = math.sqrt(1 - 2 * z / math.erf(2 / math.sqrt(2)))
    for path, spec in jflat.items():
        t = tflat[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        if path[-1] in CONST_LEAVES:
            want = 0.0 if path[-1][0] == "b" else 1.0
            assert torch.all(t == want), path
            continue
        fan_in = t.shape[-1] if path[-1] == "embed" else t.shape[-2]
        assert abs(float(t.std()) / (trunc / math.sqrt(fan_in)) - 1) < 0.05, \
            path


@pytest.mark.parametrize("arch", lm.TRAIN_FAMILIES)
def test_init_params_cast_draws_the_cast_tree(arch):
    """``init_params(..., cast=True)``: the bits of ``cast_params`` on the
    fp32 draw of the same seed, the fp32-read leaves in fp32; and
    ``cast_params`` of it copies nothing."""
    cfg = get_config(arch, tiny=True)
    full = lm.init_params(cfg, torch.Generator().manual_seed(3))
    cast = lm.init_params(cfg, torch.Generator().manual_seed(3), cast=True)
    want = lm.cast_params(full, cfg)
    assert [p for p, _ in flatten(cast)] == [p for p, _ in flatten(want)]
    for (path, a), (_, b) in zip(flatten(cast), flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        assert a.dtype == (torch.float32 if path[-1] in lm.FP32_READ
                           else torch.bfloat16), path
    again = lm.cast_params(cast, cfg)
    assert all(a is b for (_, a), (_, b) in zip(flatten(again),
                                                flatten(cast)))


# ---------------------------------------------------------------------------
# the serve engine and the launcher
# ---------------------------------------------------------------------------

def _requests(mod, n, seed, vocab):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(16, 33))
        newt = 16 if i % 3 else 32
        reqs.append(mod.Request(
            rid=i, prompt=rng.integers(1, vocab, plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=newt, arrival=0, deadline=16 * (plen + newt)))
    return reqs


@pytest.mark.parametrize("arch", NEW)
def test_engine_tokens_match_jax_engine_under_failures(arch):
    """The port's engine and JAX's on the same weights, requests, pool and
    failures: the same tokens.  (Against the batch=1 reference the MoE
    families need not be token-exact, since an expert's capacity follows
    the prefill length, bucket against exact.)"""
    jparams, _, tparams = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    treqs = _requests(serve, 6, 1, tcfg.vocab_size)
    jreqs = _requests(jserve, 6, 1, tcfg.vocab_size)
    cache_len = max(serve.prompt_bucket(r.prompt_len) + r.max_new_tokens
                    for r in treqs)
    engine = serve.ServeEngine(
        tcfg, serve.EngineConfig(cache_len=cache_len),
        pool=serve.WorkerPool(2, 2, environment="unstable", seed=0),
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
    assert len(engine.completed) == len(treqs)
    assert engine.metrics.failures >= 1
    for r in treqs:
        assert engine.output(r.rid) == jengine.output(r.rid), r.rid


@pytest.mark.parametrize("arch", NEW)
def test_serve_launcher_runs_the_family_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--tiny", "--device", "cpu", "--requests", "6",
            "--policy", "crch", "--env", "unstable"]
    res = launch_serve.main(argv + ([] if arch in MOE
                                    else ["--verify-static"]))
    out = capsys.readouterr().out
    assert f"arch={get_config(arch, tiny=True).name}" in out
    assert "completed 6/6" in out
    if arch not in MOE:
        assert "parity vs static reference: 6/6 token-exact" in out
    assert all(t.dtype != torch.float32 or name[-1] in lm.FP32_READ
               for name, t in flatten(res["engine"].params))


def test_greedy_decode_stops_at_the_first_token_off_expect():
    """The reference decode with ``expect`` (the parity check's engine
    tokens) runs to the end where they agree and stops after the first
    token that differs, with the logits of the tokens it took."""
    _, _, tparams = _weights("granite-20b")
    _, tcfg = _cfgs("granite-20b")
    req = serve.Request(rid=0, prompt=_tokens(1, 12, 8, 256)[0],
                        max_new_tokens=10)
    full, logits = serve.greedy_decode(tparams, tcfg, req, 24, device="cpu")
    same, same_logits = serve.greedy_decode(tparams, tcfg, req, 24,
                                            device="cpu", expect=full)
    assert same == full and torch.equal(same_logits, logits)
    other = list(full)
    other[4] = (other[4] + 1) % 256
    cut, cut_logits = serve.greedy_decode(tparams, tcfg, req, 24,
                                          device="cpu", expect=other)
    assert cut == full[:5] and torch.equal(cut_logits, logits[:5])
