"""Training of the recurrent families on the port against the JAX package,
part 1: the plain backwards of the three kernels the recurrent families
train through (WKV6, the RG-LRU scan, flash attention at D = 256 with a
window) against ``jax.vjp`` of the JAX functions, the autograd Functions on
the CPU, and ``forward_train``'s loss and every gradient against
``jax.grad`` for rwkv6-3b and recurrentgemma-2b (tiny), remat on and off.
Part 2 (``test_torch_train_recurrent_runs.py``) holds the training runs.

Tolerances: fp32 atol=rtol=2e-4 (the JAX kernel tests' limit) unless a test
says otherwise.  Everything runs in fp32 on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.rglru_scan import ref as jlru  # noqa: E402
from repro.kernels.rwkv6_scan import ref as jwkv  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wk_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wk_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
FAMILIES = ("rwkv6-3b", "recurrentgemma-2b")


def _rng_inputs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]


def _grads_or_zeros(grads, like):
    return [np.zeros_like(x) if g is None else np.asarray(g)
            for g, x in zip(grads, like)]


# ---------------------------------------------------------------------------
# B3: WKV6
# ---------------------------------------------------------------------------

# (B, H, T, N): T a multiple of the 16-token chunk and not, and one token
WKV_CASES = [(2, 2, 32, 8), (1, 3, 37, 8), (2, 1, 1, 4), (1, 2, 20, 64)]


def _wkv_inputs(b, h, t, n, seed):
    rng = np.random.default_rng(seed)
    r, k, v, do = (0.5 * rng.normal(size=(b, h, t, n)) for _ in range(4))
    lw = -rng.uniform(1e-4, 2.5, (b, h, t, n))
    u = 0.3 * rng.normal(size=(h, n))
    S0 = 0.3 * rng.normal(size=(b, h, n, n))
    dS = 0.3 * rng.normal(size=(b, h, n, n))
    return [x.astype(np.float32) for x in (r, k, v, lw, u, do, S0, dS)]


def _jax_wkv_vjp(r, k, v, lw, u, do, S0, dS):
    """(dr, dk, dv, dlog_w, du[, dS0]) by ``jax.vjp`` through the JAX
    kernel oracle (the sequential scan), at output gradient ``do`` and
    final-state gradient ``dS`` (zero when ``S0`` is None)."""
    args = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    if S0 is None:
        _, vjp = jax.vjp(lambda *a: jwkv.wkv6(*a), *args)
        return vjp((jnp.asarray(do), jnp.zeros(r.shape[:2] + (r.shape[3],
                                                              r.shape[3]))))
    _, vjp = jax.vjp(lambda *a: jwkv.wkv6(*a[:5], a[5]), *args,
                     jnp.asarray(S0))
    return vjp((jnp.asarray(do), jnp.asarray(dS)))


@pytest.mark.parametrize("b,h,t,n", WKV_CASES)
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_plain_wkv6_backward_matches_jax_vjp(b, h, t, n, with_s0, form):
    r, k, v, lw, u, do, S0, dS = _wkv_inputs(b, h, t, n, t + n)
    S0, dS = (S0, dS) if with_s0 else (None, None)
    want = _jax_wkv_vjp(r, k, v, lw, u, do, S0, dS)
    fn = (wk_ref.wkv6_backward if form == "sequential" else
          lambda *a: wk_ref.wkv6_backward_chunked(*a, chunk=wk_ops.CHUNK))
    got = fn(*(torch.from_numpy(x) for x in (r, k, v, lw, u, do)),
             None if S0 is None else torch.from_numpy(S0),
             None if dS is None else torch.from_numpy(dS))
    assert (got[5] is None) == (not with_s0)
    for g, w in zip([x for x in got if x is not None], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,h,t,n", WKV_CASES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_function_on_cpu_matches_jax_vjp(b, h, t, n, with_s0):
    """``ops.wkv6`` under autograd (the ``_WKV6`` Function): its forward
    and backward are the plain versions on the CPU, no launch counted."""
    r, k, v, lw, u, do, S0, dS = _wkv_inputs(b, h, t, n, 2 * t + n)
    S0, dS = (S0, dS) if with_s0 else (None, None)
    want = _jax_wkv_vjp(r, k, v, lw, u, do, S0, dS)
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (r, k, v, lw, u) + ((S0,) if with_s0 else ())]
    launches = (wk_ops.wkv6.launches, wk_ops.wkv6_bwd.launches)
    o, S = wk_ops.wkv6(*leaves[:5], leaves[5] if with_s0 else None)
    assert o.grad_fn is not None
    loss = (o * torch.from_numpy(do)).sum()
    if with_s0:
        loss = loss + (S * torch.from_numpy(dS)).sum()
    loss.backward()
    assert (wk_ops.wkv6.launches, wk_ops.wkv6_bwd.launches) == launches
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_wkv6_without_a_gradient_is_the_forward():
    r, k, v, lw, u, *_ = _wkv_inputs(1, 2, 20, 8, 3)
    tr, tk, tv, tlw, tu = (torch.from_numpy(x).requires_grad_()
                           for x in (r, k, v, lw, u))
    with torch.no_grad():
        o, S = wk_ops.wkv6(tr, tk, tv, tlw, tu)
    assert o.grad_fn is None
    o2, S2, scratch = wk_ops.wkv6_forward(tr, tk, tv, tlw, tu)
    assert scratch is None
    assert torch.equal(o, o2.detach()) and torch.equal(S, S2.detach())


# ---------------------------------------------------------------------------
# B4: the RG-LRU scan
# ---------------------------------------------------------------------------

# (B, S, W): one step, a ragged S, the 128-step chunk's edges
LRU_CASES = [(2, 1, 8), (2, 37, 16), (1, 128, 8), (3, 130, 5)]


def _lru_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, w))
    x, dh = (rng.normal(size=(b, s, w)) for _ in range(2))
    h0, dl = (rng.normal(size=(b, w)) for _ in range(2))
    return [y.astype(np.float32) for y in (a, x, h0, dh, dl)]


def _jax_lru_vjp(a, x, h0, dh, dl):
    args = [jnp.asarray(y) for y in (a, x)]
    if h0 is None:
        _, vjp = jax.vjp(lambda p, q: jlru.lru_scan(p, q), *args)
        return vjp((jnp.asarray(dh), jnp.asarray(dl)))
    _, vjp = jax.vjp(lambda p, q, r0: jlru.lru_scan(p, q, r0), *args,
                     jnp.asarray(h0))
    return vjp((jnp.asarray(dh), jnp.asarray(dl)))


@pytest.mark.parametrize("b,s,w", LRU_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_lru_backward_matches_jax_vjp(b, s, w, with_h0):
    a, x, h0, dh, dl = _lru_inputs(b, s, w, b + s + w)
    h0 = h0 if with_h0 else None
    want = _jax_lru_vjp(a, x, h0, dh, dl)
    ta = torch.from_numpy(a)
    th0 = None if h0 is None else torch.from_numpy(h0)
    h, _ = lru_ref.lru_scan(ta, torch.from_numpy(x), th0)
    got = lru_ref.lru_scan_backward(ta, h, torch.from_numpy(dh),
                                    torch.from_numpy(dl), th0)
    assert (got[2] is None) == (not with_h0)
    for g, wnt in zip([y for y in got if y is not None], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


@pytest.mark.parametrize("b,s,w", LRU_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_function_on_cpu_matches_jax_vjp(b, s, w, with_h0):
    """``ops.lru_scan`` under autograd (the ``_LruScan`` Function)."""
    a, x, h0, dh, dl = _lru_inputs(b, s, w, 3 * s + w)
    h0 = h0 if with_h0 else None
    want = _jax_lru_vjp(a, x, h0, dh, dl)
    leaves = [torch.from_numpy(y).requires_grad_()
              for y in (a, x) + ((h0,) if with_h0 else ())]
    launches = (lru_ops.lru_scan.launches, lru_ops.lru_scan_bwd.launches)
    h, last = lru_ops.lru_scan(*leaves[:2], leaves[2] if with_h0 else None)
    ((h * torch.from_numpy(dh)).sum()
     + (last * torch.from_numpy(dl)).sum()).backward()
    assert (lru_ops.lru_scan.launches,
            lru_ops.lru_scan_bwd.launches) == launches
    for y, wnt in zip(leaves, want):
        np.testing.assert_allclose(y.grad.numpy(), np.asarray(wnt), **TOL)


def test_lru_scan_without_a_gradient_is_the_forward():
    a, x, *_ = _lru_inputs(1, 20, 4, 1)
    ta, tx = (torch.from_numpy(y).requires_grad_() for y in (a, x))
    with torch.no_grad():
        h, last = lru_ops.lru_scan(ta, tx)
    assert h.grad_fn is None
    want, want_last = lru_ref.lru_scan(ta.detach(), tx.detach())
    assert torch.equal(h, want) and torch.equal(last, want_last)


# ---------------------------------------------------------------------------
# B2 at D = 256: recurrentgemma's local attention
# ---------------------------------------------------------------------------

# (B, H, KV, S, window): MQA 10:1 and GQA 2:1 at windows smaller than S
ATTN_256_CASES = [(1, 10, 1, 40, 16), (2, 4, 2, 33, 7), (1, 10, 1, 20, 1)]


def _attn_inputs(b, h, kv, s, seed, d=256):
    return _rng_inputs(seed, (b, h, s, d), (b, kv, s, d), (b, kv, s, d),
                       (b, h, s, d))


def _jax_local_sdpa_vjp(q, k, v, do, window):
    """Output and (dq, dk, dv) by ``jax.vjp`` through the model's own
    attention (``layers._sdpa``, (B, S, H, D) layout) under the local mask
    of ``attention_forward(mode="local")``, back in (B, H, S, D)."""
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kpos = jnp.arange(q.shape[2])

    def mask(qp):
        return ((qp[:, None] >= kpos[None, :])
                & (qp[:, None] - kpos[None, :] < window))

    out, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, mask),
                       t(q), t(k), t(v))
    return [np.asarray(x).transpose(0, 2, 1, 3)
            for x in (out, *vjp(t(do)))]


@pytest.mark.parametrize("b,h,kv,s,window", ATTN_256_CASES)
def test_plain_attention_backward_at_d256_matches_jax_vjp(b, h, kv, s,
                                                          window):
    q, k, v, do = _attn_inputs(b, h, kv, s, s + window)
    want = _jax_local_sdpa_vjp(q, k, v, do, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa_ref.attention(tq, tk, tv, window=window)
    lse = fa_ref.attention_lse(tq, tk, tv, window=window)
    got = [o, *fa_ref.attention_backward(tq, tk, tv, o, lse, tdo,
                                         window=window)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("b,h,kv,s,window", ATTN_256_CASES)
def test_attention_function_at_d256_on_cpu_matches_jax_vjp(b, h, kv, s,
                                                           window):
    q, k, v, do = _attn_inputs(b, h, kv, s, 2 * s + window)
    want = _jax_local_sdpa_vjp(q, k, v, do, window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    launches = (fa_ops.flash_attention.launches,
                fa_ops.flash_attention_bwd.launches)
    out = fa_ops.attention(tq, tk, tv, window=window)
    out.backward(torch.from_numpy(do))
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_bwd.launches) == launches
    for g, w in zip((out.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_d256_is_a_backward_head_dim():
    assert 256 in fa_ops.BWD_HEAD_DIMS
    assert 256 in fa_ops.TC_BWD_HEAD_DIMS


# ---------------------------------------------------------------------------
# the whole models: forward_train's loss and every gradient
# ---------------------------------------------------------------------------

def _cfgs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, tiny=True),
                               compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module", params=FAMILIES)
def tiny(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(b, s, seed, vocab=256):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    tok = tok.astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}


@pytest.fixture(scope="module")
def jax_grads(tiny):
    """JAX's loss, xent and gradients at each sequence length, once."""
    jcfg, _, jparams, _ = tiny
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.forward_train(p, jcfg, bt, xent_chunk=12),
        has_aux=True))
    out = {}
    for s in (37, 40):
        batch = _batch(2, s, seed=s)
        (loss, m), g = fn(jparams, jax.tree.map(jnp.asarray, batch))
        out[s] = (batch, float(loss), float(m["xent"]),
                  [np.asarray(x) for _, x in flatten(jax.tree.map(
                      np.asarray, g))])
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("s", [37, 40])
def test_forward_train_loss_and_every_gradient_match_jax(tiny, jax_grads,
                                                         remat, s):
    """Both families, remat on and off; S = 37 runs rwkv's sub-chunk tail
    (JAX's chunked WKV6 form takes 32 tokens in chunks, 5 one by one) and
    recurrentgemma's window (16) over a ragged length."""
    _, tcfg, _, np_tree = tiny
    batch, jloss, jxent, jgrads = jax_grads[s]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    params = unflatten(np_tree, leaves)
    loss, m = lm.forward_train(params, dataclasses.replace(tcfg, remat=remat),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, xent_chunk=12)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    np.testing.assert_allclose(float(m["xent"]), jxent, **TOL)
    for (name, _), leaf, jg in zip(flatten(np_tree), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), jg,
                                   err_msg=str(name), **TOL)


def test_forward_train_runs_in_bf16_on_the_cpu(tiny):
    """The published compute dtype: finite loss and fp32 gradients of the
    fp32 params (JAX's value cannot be had on the CPU in bf16)."""
    _, tcfg, _, np_tree = tiny
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    loss, _ = lm.forward_train(
        unflatten(np_tree, leaves),
        dataclasses.replace(tcfg, compute_dtype="bfloat16"),
        {k: torch.from_numpy(v) for k, v in _batch(2, 20, seed=8).items()})
    loss.backward()
    assert torch.isfinite(loss)
    assert all(x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
               for x in leaves)


def test_hybrid_backbone_runs_every_block_kind(tiny):
    """The tiny hybrid (5 layers, rec_per_attn 2) is one super block and
    two tail layers, as JAX lays it out; every leaf of both gets a
    gradient."""
    _, tcfg, _, np_tree = tiny
    if not tcfg.rglru:
        assert sorted(np_tree) == ["embed", "final_norm", "layers",
                                   "lm_head", "ln_in"]
        return
    assert lm.hybrid_layout(tcfg) == (1, 2)
    assert sorted(np_tree) == ["embed", "final_norm", "super", "tail"]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flatten(np_tree)]
    loss, _ = lm.forward_train(unflatten(np_tree, leaves), tcfg,
                               {k: torch.from_numpy(v) for k, v in
                                _batch(1, 24, seed=9).items()})
    loss.backward()
    for (name, _), x in zip(flatten(np_tree), leaves):
        if name[-1] == "conv_b" or name[-1] == "bias":
            continue
        assert float(x.grad.abs().max()) > 0, name
