"""The port's training path against the JAX package on the same inputs and
weights: the flash-attention backward's plain version and autograd
Function, ``forward_train`` and its gradients, AdamW, the schedule, the
data pipeline, ``make_train_step`` over 20 steps and the train launcher.

Tolerances: fp32 atol=rtol=2e-4 (the JAX kernel tests' limit) unless a test
says otherwise.  Everything runs in fp32 on the CPU: XLA on the CPU cannot
run the bf16 x bf16 -> fp32 products of the JAX model.
"""
import dataclasses
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.distributed.steps import make_train_step as jmake  # noqa: E402
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.ft import DynamicInterval as JInterval  # noqa: E402
from repro.ft import FaultInjector as JInjector  # noqa: E402
from repro.ft import TrainingCoordinator as JCoordinator  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.distributed import make_train_step  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import cosine_schedule  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-4, rtol=2e-4)

# (B, H, KV, S, D, causal, window): MHA, GQA 2 and 4, bidirectional, a
# sliding window and the one-key window
ATTN_CASES = [(2, 4, 4, 24, 16, True, 0), (1, 4, 2, 33, 16, True, 0),
              (2, 4, 1, 20, 8, False, 0), (1, 4, 2, 40, 16, True, 7),
              (1, 2, 2, 17, 8, True, 1)]


def _attn_inputs(b, h, kv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d),
                          (b, h, s, d))]


def _jax_mask(s, causal, window):
    kpos = jnp.arange(s)
    if not causal:
        return None
    if window:
        return lambda qp: ((qp[:, None] >= kpos[None, :])
                           & (qp[:, None] - kpos[None, :] < window))
    return lambda qp: qp[:, None] >= kpos[None, :]


def _jax_sdpa_vjp(q, k, v, do, causal, window):
    """Output and (dq, dk, dv) by ``jax.vjp`` through the model's own
    attention (``layers._sdpa``, (B, S, H, D) layout), back in (B, H, S, D)."""
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    mask = _jax_mask(q.shape[2], causal, window)
    out, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, mask),
                       t(q), t(k), t(v))
    grads = vjp(t(do))
    return [np.asarray(x).transpose(0, 2, 1, 3) for x in (out, *grads)]


def _torch(*xs, grad=False):
    return [torch.from_numpy(x.copy()).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", ATTN_CASES)
def test_plain_backward_matches_jax_vjp_through_sdpa(b, h, kv, s, d, causal,
                                                     window):
    q, k, v, do = _attn_inputs(b, h, kv, s, d)
    want = _jax_sdpa_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = _torch(q, k, v, do)
    o = ref.attention(tq, tk, tv, causal=causal, window=window)
    lse = ref.attention_lse(tq, tk, tv, causal=causal, window=window)
    got = [o, *ref.attention_backward(tq, tk, tv, o, lse, tdo,
                                      causal=causal, window=window)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window",
                         [c for c in ATTN_CASES if not c[6]])
def test_plain_backward_matches_jax_vjp_through_the_kernel_oracle(
        b, h, kv, s, d, causal, window):
    """The JAX kernel's oracle (``kernels/flash_attention/ref.py``) has no
    window: the windowless cases."""
    q, k, v, do = _attn_inputs(b, h, kv, s, d, seed=1)
    out, vjp = jax.vjp(lambda a, c, e: jref.attention(a, c, e, causal=causal),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = [out, *vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = _torch(q, k, v, do)
    o = ref.attention(tq, tk, tv, causal=causal)
    lse = ref.attention_lse(tq, tk, tv, causal=causal)
    got = [o, *ref.attention_backward(tq, tk, tv, o, lse, tdo,
                                      causal=causal)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", ATTN_CASES)
def test_plain_lse_matches_jax_logsumexp(b, h, kv, s, d, causal, window):
    q, k, v, _ = _attn_inputs(b, h, kv, s, d, seed=2)
    g = h // kv
    qg = jnp.asarray(q).reshape(b, kv, g, s, d)
    scores = jnp.einsum("bkgqd,bksd->bkgqs", qg, jnp.asarray(k)) / d ** 0.5
    mask = _jax_mask(s, causal, window)
    if mask is not None:
        scores = jnp.where(mask(jnp.arange(s))[None, None, None], scores,
                           -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, s)
    tq, tk, tv = _torch(q, k, v)
    got = ref.attention_lse(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", ATTN_CASES)
def test_autograd_function_on_cpu_matches_jax(b, h, kv, s, d, causal,
                                              window):
    """On the CPU the Function's forward and backward are the plain
    versions, and no kernel launch is counted."""
    q, k, v, do = _attn_inputs(b, h, kv, s, d, seed=3)
    want = _jax_sdpa_vjp(q, k, v, do, causal, window)
    tq, tk, tv = _torch(q, k, v, grad=True)
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    out = ops.attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (fwd, bwd)
    for g, w in zip((out.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_gradient_of_transposed_projection_views_needs_no_copy():
    """The model hands the kernel (B, S, H, D) projections as transposed
    views; their gradients come back as contiguous (B, S, H, D) tensors."""
    q, k, v, do = _attn_inputs(1, 4, 2, 12, 8, seed=4)
    qs, ks, vs = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
                  .requires_grad_() for x in (q, k, v))
    out = ops.attention(qs.transpose(1, 2), ks.transpose(1, 2),
                        vs.transpose(1, 2))
    out.backward(torch.from_numpy(do))
    for x in (qs, ks, vs):
        assert x.grad.is_contiguous()
    dq, dk, dv = ops.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(out.detach().numpy().copy()),
        ref.attention_lse(*(torch.from_numpy(a) for a in (q, k, v))),
        torch.from_numpy(do))
    np.testing.assert_allclose(dq.numpy(),
                               qs.grad.numpy().transpose(0, 2, 1, 3), **TOL)


def test_attention_without_a_gradient_is_the_forward():
    q, k, v, _ = _attn_inputs(1, 2, 2, 9, 8, seed=5)
    tq, tk, tv = _torch(q, k, v, grad=True)
    with torch.no_grad():
        out = ops.attention(tq, tk, tv)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), ops.flash_attention(tq, tk, tv).detach().numpy())
    o, lse = ops.flash_attention(tq, tk, tv, return_lse=True)
    np.testing.assert_array_equal(o.detach().numpy(), out.numpy())
    np.testing.assert_array_equal(
        lse.detach().numpy(), ref.attention_lse(tq, tk, tv).detach().numpy())


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = _torch(*_attn_inputs(1, 2, 2, 9, 8, seed=6))
    o = ref.attention(q, k, v)
    lse = ref.attention_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :, :-1], do)
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention_bwd(q, k, v, o[:, :, :-1], lse, do)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False, window=3)


# ---------------------------------------------------------------------------
# the model's training forward
# ---------------------------------------------------------------------------

def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("olmo-1b", tiny=True),
                               compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(b, s, seed, vocab=256):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    tok = tok.astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}


def _leaf_params(np_tree):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    from repro_torch.tree import unflatten
    return unflatten(np_tree, leaves), leaves


@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_loss_and_every_gradient_match_jax(tiny, remat):
    jcfg, tcfg, jparams, np_tree = tiny
    batch = _batch(2, 32, seed=7)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jcfg, jax.tree.map(jnp.asarray, batch),
                                    xent_chunk=12), has_aux=True)(jparams)
    params, leaves = _leaf_params(np_tree)
    loss, m = lm.forward_train(params, dataclasses.replace(tcfg, remat=remat),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, xent_chunk=12)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), **TOL)
    names = [p for p, _ in flatten(np_tree)]
    for name, (_, jg), leaf in zip(names, flatten(jax.tree.map(
            np.asarray, jgrads)), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, err_msg=str(name),
                                   **TOL)


@pytest.mark.parametrize("s,chunk", [(32, 12), (30, 512), (24, 8)])
def test_chunked_xent_matches_jax(s, chunk):
    rng = np.random.default_rng(s + chunk)
    h = rng.normal(size=(2, s, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    tgt = rng.integers(0, 40, (2, s)).astype(np.int32)
    mask = (rng.uniform(size=(2, s)) > 0.2).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jlm.chunked_xent(
        a, b, jnp.asarray(tgt), jnp.asarray(mask), chunk=chunk),
        jnp.asarray(h), jnp.asarray(w))
    dh, dw = vjp(jnp.ones((), jnp.float32))
    th, tw = _torch(h, w, grad=True)
    got = lm.chunked_xent(th, tw, torch.from_numpy(tgt),
                          torch.from_numpy(mask), chunk=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), **TOL)


def test_only_the_dense_family_trains():
    for arch in ("rwkv6-3b", "recurrentgemma-2b"):
        with pytest.raises(ValueError, match="olmo-1b"):
            lm.check_train_family(get_config(arch, tiny=True))
    lm.check_train_family(get_config("olmo-1b", tiny=True))
    with pytest.raises(ValueError, match="olmo-1b"):
        make_train_step(get_config("rwkv6-3b", tiny=True))


def test_forward_train_runs_in_bf16_on_the_cpu(tiny):
    """The published compute dtype: finite loss and fp32 gradients of the
    fp32 params (JAX's value cannot be had on the CPU in bf16)."""
    _, tcfg, _, np_tree = tiny
    params, leaves = _leaf_params(np_tree)
    loss, _ = lm.forward_train(params, dataclasses.replace(
        tcfg, compute_dtype="bfloat16"), {k: torch.from_numpy(v) for k, v in
                                          _batch(2, 16, seed=8).items()})
    loss.backward()
    assert torch.isfinite(loss)
    assert all(x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
               for x in leaves)


# ---------------------------------------------------------------------------
# AdamW, the schedule, the pipeline
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (6, 4), "final_norm": {"scale": (4,)},
              "layers": {"attn": {"wq": (2, 4, 4), "wo": (2, 4, 4)},
                         "ln1": {}, "mlp": {"w_up": (2, 4, 8),
                                            "w_down": (2, 8, 4)},
                         "rec": {"lam": (2, 4), "bias": (2, 4)}}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return rng.normal(size=node).astype(np.float32)

    return make(shapes), make(shapes)


def _to_torch_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_jax_over_two_steps(master):
    """Two updates from ``adamw_init``: new params, mu, nu, master, the step
    and the gradient norm (clipping engaged: the norm is above 1)."""
    np_params, np_grads = _opt_tree(9)
    jcfg = jadamw.AdamWConfig(lr=1e-2)
    tcfg = adamw.AdamWConfig(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jadamw.adamw_init(jp, master=master)
    tp = _to_torch_tree(np_params)
    ts = adamw.adamw_init(tp, master=master)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    assert sorted(ts) == sorted(js)
    for i in range(2):
        scale = 0.5 + i
        g = jax.tree.map(lambda a: jnp.asarray(a) * scale, np_grads)
        jp, js, jm = jadamw.adamw_update(jcfg, jp, g, js, lr_scale=0.7)
        before = [t.clone() for _, t in flatten({"p": tp, "s": ts})]
        tp2, ts2, tm = adamw.adamw_update(
            tcfg, tp, _to_torch_tree(jax.tree.map(np.asarray, g)), ts,
            lr_scale=np.float32(0.7))
        # out of place: the inputs are untouched
        assert all(torch.equal(x, y) for x, (_, y) in
                   zip(before, flatten({"p": tp, "s": ts})))
        tp, ts = tp2, ts2
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ["mu", "nu"] + (["master"] if master else []):
            for (pa, a), (_, b) in zip(flatten(ts[key]), flatten(
                    jax.tree.map(np.asarray, js[key]))):
                np.testing.assert_allclose(a.numpy(), b, err_msg=str(pa),
                                           **TOL)
        for (pa, a), (_, b) in zip(flatten(tp), flatten(
                jax.tree.map(np.asarray, jp))):
            np.testing.assert_allclose(a.numpy(), b, err_msg=str(pa), **TOL)


def test_decay_mask_names_match_jax():
    names = ["embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
             "scale", "bias", "ln_scale", "lam", "ww", "mu", "u", "ba", "bx",
             "lm_head", "enc_pos", "w"]
    for n in names:
        path = (jax.tree_util.DictKey("layers"), jax.tree_util.DictKey(n))
        assert adamw._decay_mask(("layers", n)) == jadamw._decay_mask(path), n


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 20), (3, 20),
                                          (5, 7), (10, 6)])
def test_cosine_schedule_matches_jax(warmup, total):
    """Every operation as in JAX, in float32.  The cosine is libm's,
    correctly rounded; XLA's float32 cosine may differ from it in the last
    bit, so the values are held to one float32 ulp, and exactly where no
    cosine is taken (the warm-up and the floor)."""
    steps = sorted(set(range(0, min(total, 400) + 3))
                   | set(range(max(0, total - 300), total + 3)))
    for s in steps:
        want = np.float32(jcosine(s, warmup=warmup, total=total))
        got = cosine_schedule(s, warmup=warmup, total=total)
        assert isinstance(got, np.float32)
        ulp = abs(int(want.view(np.int32)) - int(got.view(np.int32)))
        assert ulp <= 1, (s, want, got)
        if s < warmup or s >= total:
            assert got == want, (s, want, got)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_pipeline_batches_are_byte_equal(n_hosts):
    jcfg, tcfg = _cfgs()
    jp = JPipeline(JDataConfig(8, 48, seed=5), jcfg)
    tp = SyntheticTokenPipeline(DataConfig(8, 48, seed=5), tcfg)
    for idx in (0, 1, 17):
        for host in range(n_hosts):
            a = jp.batch_at(idx, host=host, n_hosts=n_hosts)
            b = tp.batch_at(idx, host=host, n_hosts=n_hosts)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
    next(jp), next(tp)
    assert jp.state() == tp.state()
    again = SyntheticTokenPipeline.from_state(tp.cfg, tcfg, tp.state())
    assert again.next_index == 1


# ---------------------------------------------------------------------------
# make_train_step: a 20-step trajectory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(tiny):
    jcfg = tiny[0]
    return {accum: jax.jit(jmake(jcfg, jadamw.AdamWConfig(lr=1e-3),
                                 accum_steps=accum, q_chunk=32,
                                 xent_chunk=16, warmup=3, total_steps=20))
            for accum in (1, 2)}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_trajectory_matches_jax_over_20_steps(tiny, jax_steps,
                                                         accum):
    """From the same init (``params_from_jax``, ``state_from_jax``) on the
    same batches: every step's loss and gradient norm, and the final params
    and moments."""
    jcfg, tcfg, jparams, np_tree = tiny
    js = jadamw.adamw_init(jparams)
    tp = lm.params_from_jax(np_tree, tcfg, device="cpu")
    ts = adamw.state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    tstep = make_train_step(tcfg, adamw.AdamWConfig(lr=1e-3),
                            accum_steps=accum, q_chunk=32, xent_chunk=16,
                            warmup=3, total_steps=20)
    jpipe = JPipeline(JDataConfig(4, 32, seed=1), jcfg)
    tpipe = SyntheticTokenPipeline(DataConfig(4, 32, seed=1), tcfg)
    jp = jparams
    for i in range(20):
        jp, js, jm = jax_steps[accum](jp, js, jpipe.batch_at(i))
        tp, ts, tm = tstep(tp, ts, tpipe.batch_at(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   err_msg=f"step {i}", **TOL)
    assert int(ts["step"]) == int(js["step"]) == 20
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]),
                           (ts["nu"], js["nu"])):
        for (name, a), (_, b) in zip(flatten(tree_t), flatten(
                jax.tree.map(np.asarray, tree_j))):
            np.testing.assert_allclose(a.numpy(), b, err_msg=str(name),
                                       **TOL)


def test_train_step_leaves_its_inputs_unchanged(tiny):
    _, tcfg, _, np_tree = tiny
    params = lm.params_from_jax(np_tree, tcfg, device="cpu")
    state = adamw.adamw_init(params)
    step = make_train_step(tcfg, xent_chunk=16, warmup=1)
    # the schedule's scale is 0 at step 0: the second step moves the params
    params, state, _ = step(params, state, _batch(2, 16, seed=10))
    before = [t.clone() for _, t in flatten({"p": params, "s": state})]
    new_p, new_s, _ = step(params, state, _batch(2, 16, seed=11))
    after = [t for _, t in flatten({"p": params, "s": state})]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(new_p["embed"], params["embed"])
    assert int(new_s["step"]) == 2 and int(state["step"]) == 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--tiny", "--device", "cpu", "--steps", "12",
               "--global-batch", "4", "--seq-len", "32",
               "--inject-mtbf-steps", "5", "--seed", "0"]


def test_launcher_matches_a_jax_coordinator(tmp_path, tiny):
    """``launch/train.py``'s code path (the JAX launcher's settings: AdamW
    at --lr, q_chunk min(1024, seq_len), xent_chunk 512, total_steps
    --steps, the Weibull injector, the dynamic interval) on JAX's init in
    fp32, against a ``TrainingCoordinator`` of the JAX package built here
    with the same settings (the JAX launcher itself fails on this jax under
    its debug mesh): the same failures, restores, replayed steps and
    checkpoints, and the same losses."""
    jcfg, tcfg, jparams, np_tree = tiny
    args = launch.build_parser().parse_args(
        LAUNCH_ARGS + ["--ckpt-dir", str(tmp_path / "port")])
    built = launch.build(tcfg, args, params=lm.params_from_jax(
        np_tree, tcfg, device="cpu"))
    got = launch.run(tcfg, args, built)["report"]
    jcoord = JCoordinator(
        train_step=jax.jit(jmake(jcfg, jadamw.AdamWConfig(lr=3e-4),
                                 q_chunk=32, xent_chunk=512,
                                 total_steps=12)),
        params=jparams, opt_state=jadamw.adamw_init(jparams),
        pipeline=JPipeline(JDataConfig(4, 32, seed=0), jcfg),
        store=JStore(str(tmp_path / "jax")),
        interval=JInterval(gamma_s=5.0),
        injector=JInjector(mtbf_steps=5.0, seed=0, horizon_steps=12))
    want = jcoord.run(12)
    assert want.failures > 0
    for field in ("steps_completed", "failures", "restores", "wasted_steps",
                  "checkpoints", "index_violations"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_allclose(got.losses, want.losses, **TOL)


def test_launcher_cli_on_the_cpu_and_its_refusals():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS[:-4],
         "--steps", "4", "--chaos", "unstable", "--chaos-seed", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert any(l.startswith("arch=olmo-tiny") and "restores=" in l
               for l in lines)
    assert any(l.startswith("loss: first10%=") for l in lines)
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--arch", "rwkv6-3b", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "olmo-1b" in bad.stderr
