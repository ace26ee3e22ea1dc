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
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ops as pa_ops  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ref as pa_ref  # noqa: E402

# the shapes and tolerances of tests/test_kernels.py
PA_SHAPES = [(16, 4), (100, 10), (130, 3), (256, 64)]
FA_SHAPES = [(1, 4, 2, 128, 128), (2, 8, 8, 256, 128), (1, 2, 1, 130, 128),
             (1, 4, 2, 384, 256)]
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
