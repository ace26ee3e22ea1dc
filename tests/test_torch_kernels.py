"""The port's kernels: plain versions against the JAX package's oracles and
Pallas kernels, and the CPU dispatch of the wrappers.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.kernels.pairwise_affinity import ops as jpa_ops  # noqa: E402
from repro.kernels.pairwise_affinity import ref as jpa_ref  # noqa: E402
from repro.kernels.rglru_scan import ops as jlru_ops  # noqa: E402
from repro.kernels.rglru_scan import ref as jlru_ref  # noqa: E402
from repro.kernels.rwkv6_scan import ops as jwk_ops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as jwk_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ops as pa_ops  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ref as pa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wk_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wk_ref  # noqa: E402

# the shapes and tolerances of tests/test_kernels.py
PA_SHAPES = [(16, 4), (100, 10), (130, 3), (256, 64)]
FA_SHAPES = [(1, 4, 2, 128, 128), (2, 8, 8, 256, 128), (1, 2, 1, 130, 128),
             (1, 4, 2, 384, 256)]
LRU_SHAPES = [(2, 128, 128), (3, 100, 96), (8, 256, 256), (1, 17, 130)]
WKV_SHAPES = [(1, 2, 32, 64), (2, 3, 48, 64), (1, 1, 20, 64),
              (1, 2, 64, 128)]
PA_TOL = dict(atol=3e-3, rtol=1e-3)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # fp32: summation order only; bf16: the inputs' and output's rounding
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=2e-4, rtol=2e-4)


def _assert_distances_close(got, want, pts):
    """Off the diagonal, the stated pairwise tolerance.  On it the exact
    answer is 0 and the Gram expansion returns sqrt of the cancellation
    noise of |x|^2 + |x|^2 - 2<x, x>, which depends on the summation order:
    both sides must lie within sqrt(8 eps |x|^2) of 0."""
    got, want = _f32(got), _f32(want)
    off = ~np.eye(len(pts), dtype=bool)
    np.testing.assert_allclose(got[off], want[off], **PA_TOL)
    bound = np.sqrt(8 * np.finfo(np.float32).eps
                    * (pts.astype(np.float64) ** 2).sum(1))
    assert (np.abs(np.diag(got)) <= bound).all()
    assert (np.abs(np.diag(want)) <= bound).all()


def _points(n, f, seed=0):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _qkv(b, h, kv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("n,f", PA_SHAPES)
def test_pairwise_plain_matches_jax_oracle(n, f):
    pts = _points(n, f)
    got = pa_ref.pairwise_distance(torch.from_numpy(pts))
    want = jpa_ref.pairwise_distance(jnp.asarray(pts))
    _assert_distances_close(got, want, pts)


@pytest.mark.parametrize("b,h,kv,s,d", FA_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_oracle(b, h, kv, s, d, dtype, causal):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(b, h, kv, s, d)
    got = fa_ref.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           causal=causal)
    want = jfa_ref.attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                             causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, s, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_plain_versions_match_pallas_interpret():
    """One small shape each against the Pallas kernels, run in interpret
    mode as the JAX package's own tests run them on the CPU."""
    pts = _points(100, 10, seed=1)
    _assert_distances_close(
        pa_ref.pairwise_distance(torch.from_numpy(pts)),
        jpa_ops.pairwise_distance(jnp.asarray(pts), interpret=True), pts)
    q, k, v = _qkv(1, 4, 2, 128, 128, seed=1)
    np.testing.assert_allclose(
        _f32(fa_ref.attention(*map(torch.from_numpy, (q, k, v)))),
        _f32(jfa_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True, interpret=True)),
        **_tol("float32"))


def _wkv_inputs(b, h, t, n, seed=0):
    """The inputs of tests/test_kernels.py's WKV6 case, and a state."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, h, t, n)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(0.01, 2.5, (b, h, t, n)).astype(np.float32)
    u = 0.2 * rng.normal(size=(h, n)).astype(np.float32)
    S0 = 0.3 * rng.normal(size=(b, h, n, n)).astype(np.float32)
    return r, k, v, lw, u, S0


def _lru_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.8, 0.999, (b, s, w)).astype(np.float32),
            (0.1 * rng.normal(size=(b, s, w))).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32))


@pytest.mark.parametrize("b,h,t,n", WKV_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wkv6_plain_matches_jax_oracle_and_pallas(b, h, t, n, dtype):
    """Against JAX ``ref.wkv6`` with an entering state (output and final
    state), and against the Pallas kernel in interpret mode from zero (the
    Pallas kernel has no state in or out).  fp32 at 2e-4; bf16 r, k, v at
    the bf16 tolerance of tests/test_kernels.py (both sides compute in
    fp32 and round the output once)."""
    jdt, tdt = DTYPES[dtype]
    r, k, v, lw, u, S0 = _wkv_inputs(b, h, t, n)
    tin = [torch.from_numpy(x).to(tdt) for x in (r, k, v)]
    jin = [jnp.asarray(x, jdt) for x in (r, k, v)]
    got, gS = wk_ref.wkv6(*tin, torch.from_numpy(lw), torch.from_numpy(u),
                          torch.from_numpy(S0))
    want, wS = jwk_ref.wkv6(*jin, jnp.asarray(lw), jnp.asarray(u),
                            jnp.asarray(S0))
    assert got.dtype == tdt and gS.dtype == torch.float32
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(gS), _f32(wS), **_tol("float32"))
    got0, _ = wk_ref.wkv6(*tin, torch.from_numpy(lw), torch.from_numpy(u))
    pallas = jwk_ops.wkv6(*jin, jnp.asarray(lw), jnp.asarray(u),
                          interpret=True)
    np.testing.assert_allclose(_f32(got0), _f32(pallas), **tol)


@pytest.mark.parametrize("b,s,w", LRU_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_plain_matches_jax_oracle_and_pallas(b, s, w, with_h0):
    """fp32 at 2e-4, h and h_last, against JAX ``ref.lru_scan`` and (from
    a zero state, which is all it takes) the Pallas kernel in interpret
    mode."""
    a, x, h0 = _lru_inputs(b, s, w)
    th0 = torch.from_numpy(h0) if with_h0 else None
    jh0 = jnp.asarray(h0) if with_h0 else None
    got, glast = lru_ref.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                                  th0)
    want, wlast = jlru_ref.lru_scan(jnp.asarray(a), jnp.asarray(x), jh0)
    assert got.dtype == glast.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))
    np.testing.assert_allclose(_f32(glast), _f32(wlast), **_tol("float32"))
    if not with_h0:
        pallas = jlru_ops.lru_scan(jnp.asarray(a), jnp.asarray(x),
                                   interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas),
                                   **_tol("float32"))


@pytest.mark.parametrize("b,s,w,chunk", [(2, 1, 8, 4), (1, 17, 130, 4),
                                         (3, 100, 96, 16), (2, 128, 40, 128),
                                         (1, 129, 33, 128), (2, 300, 64, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_chunked_matches_plain_and_jax_oracle(b, s, w, chunk,
                                                       with_h0):
    """The CUDA kernel's two-pass arithmetic (chunk summaries, carry-ins in
    chunk order, each chunk re-run) against the doubling scan and JAX
    ``ref.lru_scan``, fp32 at 2e-4, h and h_last, at S under, at and past
    a chunk."""
    a, x, h0 = _lru_inputs(b, s, w, seed=s + chunk)
    th0 = torch.from_numpy(h0) if with_h0 else None
    got, glast = lru_ref.lru_scan_chunked(torch.from_numpy(a),
                                          torch.from_numpy(x), th0, chunk)
    assert got.shape == (b, s, w) and glast.shape == (b, w)
    plain, plast = lru_ref.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                                    th0)
    want, wlast = jlru_ref.lru_scan(jnp.asarray(a), jnp.asarray(x),
                                    jnp.asarray(h0) if with_h0 else None)
    for ref_h, ref_last in ((_f32(plain), _f32(plast)),
                            (_f32(want), _f32(wlast))):
        np.testing.assert_allclose(_f32(got), ref_h, **_tol("float32"))
        np.testing.assert_allclose(_f32(glast), ref_last, **_tol("float32"))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 33, 77])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("fill", ["uniform", "min", "max"])
def test_wkv6_chunked_matches_plain_jax_oracle_and_pallas(t, n, fill):
    """The CUDA kernel's chunk-parallel arithmetic (chunk summaries, the
    fold over chunks, each chunk's outputs from its entering state) against
    the sequential ``ref.wkv6`` and JAX ``ref.wkv6`` with an entering state
    (output and final state), and against the Pallas kernel in interpret
    mode from zero (its wrapper pads T).  T under, at and past one and two
    chunks; log_w uniform in [-2.5, -0.01] as in tests/test_kernels.py and
    at both ends of the model's clamp [-2.5, -1e-4].  fp32 at atol 2e-4,
    rtol 1e-3 (the limit the card holds the kernel to)."""
    r, k, v, lw, u, S0 = _wkv_inputs(2, 2, t, n, seed=t + n)
    if fill != "uniform":
        lw = np.full_like(lw, -2.5 if fill == "min" else -1e-4)
    tol = dict(atol=2e-4, rtol=1e-3)
    tin = [torch.from_numpy(x) for x in (r, k, v, lw, u)]
    jin = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    got, gS = wk_ref.wkv6_chunked(*tin, torch.from_numpy(S0),
                                  chunk=wk_ops.CHUNK)
    assert got.shape == (2, 2, t, n) and gS.shape == (2, 2, n, n)
    plain, pS = wk_ref.wkv6(*tin, torch.from_numpy(S0))
    want, wS = jwk_ref.wkv6(*jin, jnp.asarray(S0))
    for ref_o, ref_S in ((plain, pS), (want, wS)):
        np.testing.assert_allclose(_f32(got), _f32(ref_o), **tol)
        np.testing.assert_allclose(_f32(gS), _f32(ref_S), **tol)
    got0, _ = wk_ref.wkv6_chunked(*tin, chunk=wk_ops.CHUNK)
    np.testing.assert_allclose(
        _f32(got0), _f32(jwk_ops.wkv6(*jin, interpret=True)), **tol)


def test_wkv6_chunked_holds_the_limit_on_a_long_slow_decay():
    """3000 tokens with every decay at the clamp's end near 1 (log_w =
    -1e-4): the kernel's arithmetic in fp32 (fp32 fold over the chunks)
    against the same recurrence evaluated in fp64, sequential and chunked,
    at the fp32 limit.  The sequential fp32 form multiplies the state by
    one rounded w 3000 times and is no oracle here."""
    r, k, v, lw, u, S0 = _wkv_inputs(1, 2, 3000, 64, seed=9)
    tin = [torch.from_numpy(x) for x in (r, k, v, np.full_like(lw, -1e-4),
                                         u, S0)]
    got, gS = wk_ref.wkv6_chunked(*tin, chunk=wk_ops.CHUNK)
    for fn in (wk_ref.wkv6, wk_ref.wkv6_chunked):
        want, wS = fn(*(x.double() for x in tin))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(_f32(gS), _f32(wS), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("s,window", [(40, 16), (130, 64), (64, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_windowed_flash_plain_matches_jax_local_mask(s, window, dtype):
    """The windowed plain version against the JAX model's attention with
    its local mask (``layers._sdpa``, as ``attention_forward(mode="local")``
    builds it), MQA at recurrentgemma's head ratio."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(1, 4, 1, s, 32, seed=3)
    got = fa_ref.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           causal=True, window=window)
    kpos = jnp.arange(s)
    mask = lambda qp: ((qp[:, None] >= kpos[None, :])  # noqa: E731
                       & (qp[:, None] - kpos[None, :] < window))
    want = jlayers._sdpa(*(jnp.asarray(x, jdt).transpose(0, 2, 1, 3)
                           for x in (q, k, v)), mask)
    np.testing.assert_allclose(_f32(got), _f32(want.transpose(0, 2, 1, 3)),
                               **_tol(dtype))


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor reaches the plain version bit for bit and launches no
    kernel; a device without a kernel raises instead of falling back."""
    pa_before = pa_ops.pairwise_distance.launches
    fa_before = fa_ops.flash_attention.launches
    pts = torch.from_numpy(_points(37, 5, seed=2))
    assert torch.equal(pa_ops.pairwise_distance(pts),
                       pa_ref.pairwise_distance(pts))
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 40, 16, seed=2))
    for causal in (True, False):
        assert torch.equal(fa_ops.flash_attention(q, k, v, causal=causal),
                           fa_ref.attention(q, k, v, causal=causal))
    assert pa_ops.pairwise_distance.launches == pa_before == 0
    assert fa_ops.flash_attention.launches == fa_before == 0
    with pytest.raises(ValueError):
        pa_ops.pairwise_distance(pts.to("meta"))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_new_wrappers_take_plain_version_on_cpu():
    """The same for the WKV6 and RG-LRU wrappers and the windowed flash
    attention; a window without causality is refused."""
    r, k, v, lw, u, S0 = (torch.from_numpy(x)
                          for x in _wkv_inputs(1, 2, 21, 64, seed=4))
    a, x, h0 = (torch.from_numpy(t) for t in _lru_inputs(2, 19, 40, seed=4))
    for got, want in ((wk_ops.wkv6(r, k, v, lw, u, S0),
                       wk_ref.wkv6(r, k, v, lw, u, S0)),
                      (lru_ops.lru_scan(a, x, h0),
                       lru_ref.lru_scan(a, x, h0))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    q, kk, vv = (torch.from_numpy(t) for t in _qkv(1, 4, 1, 40, 32, seed=4))
    assert torch.equal(fa_ops.flash_attention(q, kk, vv, window=16),
                       fa_ref.attention(q, kk, vv, window=16))
    assert wk_ops.wkv6.launches == lru_ops.lru_scan.launches == 0
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, kk, vv, causal=False, window=16)
    with pytest.raises(ValueError):
        wk_ops.wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))
    with pytest.raises(ValueError):
        lru_ops.lru_scan(a.to("meta"), x.to("meta"))


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """A library's name hashes its source, every ``csrc/*.cuh`` header and
    the flags: editing a header the flash kernels include rebuilds them
    instead of loading a stale library.  Every header a source includes
    lies in ``csrc/``."""
    import re

    from repro_torch.kernels import _build
    for src in sorted(_build.CSRC.glob("*.cu")):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (_build.CSRC / inc).is_file(), (src.name, inc)
    assert re.search(r'#include\s+"hopper.cuh"',
                     (_build.CSRC / "flash_attention_bwd.cu").read_text())
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, _build._lib_path("k")}) == 3
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._lib_path("k") not in {first, second}
