"""The encoder-decoder (whisper-small) and image-prefix
(llava-next-mistral-7b) families of the port against the JAX package on the
same weights: configs, the bidirectional and cross attention (the cross
q/k/v without their biases, ``bo`` after ``wo``), cross-attention decode,
the GELU MLP with biases, each family's prefill / per-row decode logits,
``forward_train``'s loss and every gradient, a 20-step train trajectory,
checkpoints restored across the packages, the serve engine under failures,
the launcher's ``--verify-static`` and ``--static``, and the engine's
refusals.

Tolerances: fp32 atol=rtol=2e-4 (the JAX kernel tests' limit); bf16 5e-2
against the JAX function in fp32 on the same bf16-rounded inputs and
weights; tokens exactly.  The leaves JAX initialises to constants (norm
scales and biases, attention and MLP biases) are perturbed so that a
missing or misplaced one shows.
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
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.distributed.steps import make_train_step as jmake  # noqa: E402
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.distributed import make_train_step  # noqa: E402
from repro_torch.ft import CheckpointStore  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
ARCHS = ("whisper-small", "llava-next-mistral-7b")
#: leaves JAX initialises to constants: perturbed in the tests
CONST_LEAVES = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}


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


def _side(cfg, b, seed):
    """The family's side inputs for ``b`` rows: frames or image embeds."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.normal(size=(b, cfg.n_frames, cfg.d_model))
                .astype(np.float32)}
    return {"image_embeds": rng.normal(
        size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}


def _both(batch):
    """The same numpy batch for JAX and for the port."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_by_field(arch, tiny):
    want = dataclasses.asdict(jax_get_config(arch, tiny=tiny))
    assert dataclasses.asdict(get_config(arch, tiny=tiny)) == want


# ---------------------------------------------------------------------------
# bidirectional and cross attention, the GELU MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bidir", "cross"])
def test_attention_matches_jax(mode, dtype):
    """whisper's encoder attention (no mask, no rope, biased q/k/v) and its
    cross-attention (queries of 20 decoder rows against 32 frames: no
    q/k/v bias though the layer holds them, ``bo`` after ``wo``) with their
    K/V; then a cross-attention decode step (q unbiased, no mask)."""
    _, np_tree, _ = _weights("whisper-small")
    jcfg, tcfg = _cfgs("whisper-small")
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    p_np = {k: v[0] for k, v in np_tree["layers"][
        "xattn" if mode == "cross" else "attn"].items()}
    assert {"bq", "bk", "bv", "bo"} <= set(p_np)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    ctx = rng.normal(size=(2, 32, 64)).astype(np.float32)
    xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        x, ctx, xd = _bf16_round(x), _bf16_round(ctx), _bf16_round(xd)
        p_np = {k: _bf16_round(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in p_np.items()}
    jp = jax.tree.map(jnp.asarray, p_np)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    context = dict(context=ctx) if mode == "cross" else {}
    want, (jk, jv) = jlayers.attention_forward(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), mode=mode,
        return_kv=True, **{k: jnp.asarray(v) for k, v in context.items()})
    got, (tk, tv) = layers.attention_forward(
        tp, torch.from_numpy(x).to(tdt), tcfg,
        positions=torch.from_numpy(pos.copy()), mode=mode, return_kv=True,
        **{k: torch.from_numpy(v).to(tdt) for k, v in context.items()})
    tol = TOL if dtype == "float32" else BF16_TOL
    assert tuple(tk.shape) == (2, 32 if mode == "cross" else 20, 4,
                               tcfg.head_dim)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **tol)
    if mode != "cross":
        return
    want, _ = jlayers.attention_decode(jp, jnp.asarray(xd), None, jcfg,
                                       pos=jnp.int32(5), cross_kv=(jk, jv))
    got = layers.attention_decode(tp, torch.from_numpy(xd).to(tdt), None,
                                  tcfg, pos=5, cross_kv=(tk, tv))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_gelu_mlp_with_biases_matches_jax():
    """whisper's MLP: x W_up + b_up, tanh GELU, W_down + b_down; the output
    and every gradient."""
    _, np_tree, _ = _weights("whisper-small")
    p_np = {k: np.array(v[0]) for k, v in np_tree["layers"]["mlp"].items()}
    assert set(p_np) == {"w_up", "b_up", "w_down", "b_down"}
    x = np.random.default_rng(3).normal(size=(2, 9, 64)).astype(np.float32)
    dout = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(jlayers.mlp_forward,
                        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p_np.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    got = layers.mlp_forward(tp, tx)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(_f32(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for name in p_np:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jgp[name]), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# each family: prefill, decode, forward_train, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill with per-row last positions (counted from the first image
    row), the cache it primes (the cross K/V too), then two decode steps
    at per-row positions (the second reads the first's cache write)."""
    jparams, _, tparams = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(1, 256, (3, 16)).astype(np.int32),
             **_side(tcfg, 3, 5)}
    off = tcfg.n_image_tokens
    last = np.asarray([9, 15, 12], np.int32) + off
    jb, tb = _both(batch)
    cache_len = off + 24
    jl, jc = jlm.prefill(jparams, jcfg, jb, cache_len,
                         last_idx=jnp.asarray(last))
    tl, tc = lm.prefill(tparams, tcfg, tb, cache_len,
                        last_idx=torch.from_numpy(last))
    assert sorted(tc) == sorted(jc) == (
        ["cross_k", "cross_v", "k", "v"] if tcfg.is_encdec else ["k", "v"])
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    for name in jc:
        np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                   err_msg=name, **TOL)
    nxt = rng.integers(1, 256, (3, 1)).astype(np.int32)
    pos = last + 1
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for _ in range(2):
        jl, jc = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jpos)
        tl, tc = lm.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                tpos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
        for name in jc:
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       err_msg=name, **TOL)
        jpos, tpos = jpos + 1, tpos + 1


def _train_batch(cfg, b, s, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    tok = tok.astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:],
            "loss_mask": np.ones((b, s), np.float32), **_side(cfg, b, seed)}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_every_gradient_match_jax(arch, remat):
    """The loss and the gradient of every leaf, taken as the train step
    takes them: the cross-attention's q/k/v biases, which the loss does not
    reach, get exact zeros (JAX's), not None."""
    jparams, np_tree, _ = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    jb, tb = _both(_train_batch(tcfg, 2, 20, 7))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jcfg, jb, xent_chunk=12)[0])(jparams)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    loss, m = lm.forward_train(unflatten(np_tree, leaves),
                               dataclasses.replace(tcfg, remat=remat), tb,
                               xent_chunk=12)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert float(m["aux"]) == 0.0
    unreached = 0
    for (name, _), (_, jg), g in zip(flatten(np_tree), flatten(
            jax.tree.map(np.asarray, jgrads)), grads):
        np.testing.assert_allclose(g.numpy(), jg, err_msg=str(name), **TOL)
        if name[-2:-1] == ("xattn",) and name[-1] in ("bq", "bk", "bv"):
            assert not g.any() and not jg.any(), name
            unreached += 1
    assert unreached == (3 if tcfg.is_encdec else 0)


@pytest.mark.parametrize("arch", ARCHS)
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
        scale = 0.02 if path[-1] in ("enc_pos", "dec_pos") else 1.0
        assert abs(float(t.std()) / (scale * trunc / math.sqrt(fan_in))
                   - 1) < 0.05, path


# ---------------------------------------------------------------------------
# training: 20 steps, checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_trajectory_matches_jax_over_20_steps(arch):
    """From the same init on the pipeline's batches (frames or image
    embeds included): every step's loss and gradient norm, the final
    params and moments; the cross biases' moments stay exact zeros."""
    jparams, np_tree, _ = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    jstep = jax.jit(jmake(jcfg, jadamw.AdamWConfig(lr=1e-3), q_chunk=16,
                          xent_chunk=16, warmup=3, total_steps=20))
    js = jadamw.adamw_init(jparams)
    tp = lm.params_from_jax(np_tree, tcfg, device="cpu")
    ts = adamw.state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    tstep = make_train_step(tcfg, adamw.AdamWConfig(lr=1e-3), q_chunk=16,
                            xent_chunk=16, warmup=3, total_steps=20)
    jpipe = JPipeline(JDataConfig(2, 16, seed=1), jcfg)
    tpipe = SyntheticTokenPipeline(DataConfig(2, 16, seed=1), tcfg)
    jp = jparams
    for i in range(20):
        jp, js, jm = jstep(jp, js, jpipe.batch_at(i))
        tp, ts, tm = tstep(tp, ts, tpipe.batch_at(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   err_msg=f"step {i}", **TOL)
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]),
                           (ts["nu"], js["nu"])):
        for (name, a), (_, b) in zip(flatten(tree_t), flatten(
                jax.tree.map(np.asarray, tree_j))):
            np.testing.assert_allclose(a.numpy(), b, err_msg=str(name),
                                       **TOL)
    if tcfg.is_encdec:
        assert not ts["mu"]["layers"]["xattn"]["bq"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_restore_between_the_packages(arch, tmp_path):
    """The tiny family's params and AdamW state (the encoder, the learned
    positions and the cross layers included): JAX writes, the port
    restores, and back."""
    jparams, np_tree, _ = _weights(arch)
    _, tcfg = _cfgs(arch)
    jtree = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    np_all = jax.tree.map(np.asarray, jtree)
    ttree = {"params": lm.params_from_jax(np_tree, tcfg, device="cpu"),
             "opt": adamw.state_from_jax(np_all["opt"], device="cpu")}
    JStore(str(tmp_path / "a")).save(5, jtree, extra={"seed": 0})
    got, step, _ = CheckpointStore(str(tmp_path / "a")).restore(ttree)
    assert step == 5
    for (pa, a), (_, b) in zip(flatten(got), flatten(np_all)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(pa))
    CheckpointStore(str(tmp_path / "b")).save(6, ttree, extra={"seed": 0})
    jgot, jstep, _ = JStore(str(tmp_path / "b")).restore(jtree)
    assert jstep == 6
    names = [pa for pa, _ in flatten(np_all)]
    assert ((("params", "dec_pos") in names) == tcfg.is_encdec)
    for (pa, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, jgot)),
                               flatten(np_all)):
        np.testing.assert_array_equal(a, b, err_msg=str(pa))


# ---------------------------------------------------------------------------
# the serve engine and the launcher
# ---------------------------------------------------------------------------

def _requests(mod, cfg, n, seed):
    """The same requests for either package: frames or image embeds drawn
    before each prompt, as the launchers draw them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(16, 33))
        newt = 16 if i % 3 else 32
        side = {k: v[0] for k, v in _side(cfg, 1, 100 + i).items()}
        reqs.append(mod.Request(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=newt, arrival=0, deadline=16 * (plen + newt),
            **side))
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine_under_failures(arch):
    """The port's engine and JAX's on the same weights, requests, pool and
    failures: the same tokens, with snapshots restored (a whisper slot's
    row holds its cross K/V)."""
    jparams, _, tparams = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    treqs = _requests(serve, tcfg, 6, 1)
    jreqs = _requests(jserve, jcfg, 6, 1)
    cache_len = max(tcfg.n_image_tokens + serve.prompt_bucket(r.prompt_len)
                    + r.max_new_tokens for r in treqs)
    engine = serve.ServeEngine(
        tcfg, serve.EngineConfig(cache_len=cache_len, snapshot_lambda=4),
        pool=serve.WorkerPool(2, 2, environment="unstable", seed=0),
        policy=serve.crch_policy(treqs, device="cpu"), params=tparams,
        device="cpu")
    jengine = jserve.ServeEngine(
        jcfg, jserve.EngineConfig(cache_len=cache_len, q_chunk=64,
                                  snapshot_lambda=4),
        pool=jserve.WorkerPool(2, 2, environment="unstable", seed=0),
        policy=jserve.crch_policy(jreqs), params=jparams)
    for tr, jr in zip(treqs, jreqs):
        engine.submit(tr)
        jengine.submit(jr)
    engine.run(max_steps=2_000)
    jengine.run(max_steps=2_000)
    assert len(engine.completed) == len(treqs)
    assert engine.metrics.failures >= 1 and engine.metrics.restores >= 1
    assert engine.metrics.prefill_tokens == jengine.metrics.prefill_tokens
    if tcfg.is_encdec:
        assert set(engine.axes) == {"k", "v", "cross_k", "cross_v"}
    for r in treqs:
        assert engine.output(r.rid) == jengine.output(r.rid), r.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_verify_static_on_the_cpu(arch, capsys):
    res = launch_serve.main(["--arch", arch, "--tiny", "--device", "cpu",
                             "--requests", "6", "--policy", "crch", "--env",
                             "unstable", "--verify-static"])
    out = capsys.readouterr().out
    assert f"arch={get_config(arch, tiny=True).name}" in out
    assert "completed 6/6" in out
    assert "parity vs static reference: 6/6 token-exact" in out
    cfg = get_config(arch, tiny=True)
    side = "frames" if cfg.is_encdec else "image_embeds"
    assert all(getattr(r, side) is not None for r in res["requests"])


@pytest.mark.parametrize("arch", ARCHS)
def test_static_baseline_matches_jax_prefill_and_decode(arch, capsys):
    """``--static`` runs on the CPU; on JAX's weights in fp32 its tokens
    are those of JAX's prefill and decode loop on the same batch."""
    launch_serve.main(["--arch", arch, "--tiny", "--device", "cpu",
                       "--static", "--requests", "2"])
    assert "[static]" in capsys.readouterr().out
    jparams, _, tparams = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    args = launch_serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "3", "--prompt-len", "12",
         "--new-tokens", "6", "--seed", "2"])
    got = launch_serve.static_main(tcfg, args, params=tparams)["tokens"]
    batch = launch_serve.static_batch(tcfg, 3, 12, 2, "cpu")
    jb = {k: jnp.asarray(v.numpy() if k == "tokens" else v.float().numpy())
          for k, v in batch.items()}
    cache_len = 12 + 6 + tcfg.n_image_tokens
    logits, cache = jlm.prefill(jparams, jcfg, jb, cache_len)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(5):
        logits, cache = jlm.decode_step(jparams, jcfg, cache, tok,
                                        jnp.int32(tcfg.n_image_tokens + 12 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate(want, axis=1))


def _refusal(case):
    arch = ("whisper-small" if case in ("no_frames", "cache_past_positions")
            else "llava-next-mistral-7b")
    _, tcfg = _cfgs(arch)
    req = _requests(serve, tcfg, 1, 3)[0]
    cache_len = (tcfg.n_image_tokens + serve.prompt_bucket(req.prompt_len)
                 + req.max_new_tokens)
    if case == "no_frames":
        req.frames = None
    elif case == "no_embeds":
        req.image_embeds = None
    elif case == "cache_past_positions":
        cache_len = tcfg.max_decode_len + 1
    else:                     # the image rows do not fit beside the bucket
        cache_len -= 1
    return tcfg, req, cache_len


REFUSALS = {"no_frames": "encoder frames", "no_embeds": "image embeds",
            "cache_past_positions": "position table",
            "image_offset": "image tokens 8"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refuses_what_jax_refuses(case):
    """A whisper request without its frames, a llava request without its
    image embeds or whose image rows + bucket + budget pass the cache, and
    a whisper cache past the learned decoder positions."""
    tcfg, req, cache_len = _refusal(case)

    def engine():
        return serve.ServeEngine(
            tcfg, serve.EngineConfig(cache_len=cache_len),
            pool=serve.WorkerPool(1, 1), device="cpu")

    with pytest.raises(ValueError, match=REFUSALS[case]):
        engine().submit(req)
