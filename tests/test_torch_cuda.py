"""The port's CUDA kernels against their plain versions, on the card only.

Imports torch and numpy alone, so that it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ops as pa_ops  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ref as pa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wk_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wk_ref  # noqa: E402

# the shapes of tests/test_kernels.py, a large B1 case and olmo-1b's prefill
# buckets; the JAX tests' fp32 and pairwise limits.  In bf16 the kernel and
# its plain version both accumulate in fp32 and round the output once, so
# they may differ by one bf16 ulp of the output (<= 2^-7 |x|), no more.
PA_SHAPES = [(16, 4), (100, 10), (130, 3), (256, 64), (4096, 10)]
FA_SHAPES = [(1, 4, 2, 128, 128), (2, 8, 8, 256, 128), (1, 2, 1, 130, 128),
             (1, 4, 2, 384, 256), (1, 16, 16, 256, 128),
             (1, 16, 16, 512, 128)]
PA_TOL = dict(atol=3e-3, rtol=1e-3)
FA_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
          torch.bfloat16: dict(atol=4e-3, rtol=1e-2)}
# windowed attention: the tiny test window, a mid one and recurrentgemma's
# MQA head shape (10 query heads, one KV head, D = 256)
FA_WINDOW_CASES = [((1, 4, 1, 200, 64), 16), ((2, 8, 2, 130, 128), 64),
                   ((1, 10, 1, 300, 256), 128)]
# the shapes of tests/test_kernels.py, plus rwkv6-3b's 40 heads at a T that
# is not a multiple of the 16-token pass
WKV_SHAPES = [(1, 2, 32, 64), (2, 3, 48, 64), (1, 1, 20, 64),
              (1, 2, 64, 128), (1, 40, 77, 64)]
# fp32: summation order (the kernel's sum over n against the einsum's).
# bf16 r, k, v: the kernel and the plain version both compute in fp32 and
# round the output to bf16 once, so they may differ by one bf16 ulp
# (<= 2^-7 |x|) and no more; the state stays fp32 on both sides
WKV_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=4e-3, rtol=1e-2)}
LRU_SHAPES = [(2, 128, 128), (3, 100, 96), (8, 256, 256), (1, 17, 130),
              (1, 301, 2560)]
LRU_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", PA_SHAPES)
def test_pairwise_kernel_on_card(cuda_device, n, f):
    pts_np = np.random.default_rng(n).normal(size=(n, f)).astype(np.float32)
    pts = torch.from_numpy(pts_np).to(cuda_device)
    before = pa_ops.pairwise_distance.launches
    got = pa_ops.pairwise_distance(pts)
    torch.cuda.synchronize()
    assert pa_ops.pairwise_distance.launches == before + 1
    g = got.cpu().numpy()
    w = pa_ref.pairwise_distance(pts).cpu().numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(g[off], w[off], **PA_TOL)
    # the exact diagonal is 0; both sides return sqrt of the Gram
    # expansion's cancellation noise, within sqrt(8 eps |x|^2)
    bound = np.sqrt(8 * np.finfo(np.float32).eps
                    * (pts_np.astype(np.float64) ** 2).sum(1))
    assert (np.abs(np.diag(g)) <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", FA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_card(cuda_device, b, h, kv, s, d, dtype, causal):
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = fa_ref.attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])
    # deterministic: a second launch gives the same bits
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_flash_kernel_reads_strided_projections(cuda_device):
    """The model hands (B, S, H, D) projections over as transposed views;
    the kernel must read them in place and return a view whose transpose
    is contiguous."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 200, 8, 64))
                                .astype(np.float32)).to(cuda_device)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = fa_ops.flash_attention(qt, kt, vt, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = fa_ref.attention(qt.contiguous(), kt.contiguous(),
                            vt.contiguous(), causal=True)
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", FA_WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_flash_kernel_on_card(cuda_device, shape, window, dtype):
    b, h, kv, s, d = shape
    rng = np.random.default_rng(s + window)
    q, k, v = (torch.from_numpy(rng.normal(size=x).astype(np.float32))
               .to(cuda_device, dtype)
               for x in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    got = fa_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = fa_ref.attention(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,n", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_kernel_on_card(cuda_device, b, h, t, n, dtype, with_s0):
    rng = np.random.default_rng(t + n)
    r, k, v = (torch.from_numpy(0.5 * rng.normal(size=(b, h, t, n)))
               .to(cuda_device, torch.float32).to(dtype) for _ in range(3))
    lw = torch.from_numpy(-rng.uniform(0.01, 2.5, (b, h, t, n))).to(
        cuda_device, torch.float32)
    u = torch.from_numpy(0.2 * rng.normal(size=(h, n))).to(
        cuda_device, torch.float32)
    S0 = (torch.from_numpy(0.3 * rng.normal(size=(b, h, n, n))).to(
        cuda_device, torch.float32) if with_s0 else None)
    before = wk_ops.wkv6.launches
    o, S = wk_ops.wkv6(r, k, v, lw, u, S0)
    torch.cuda.synchronize()
    assert wk_ops.wkv6.launches == before + 1
    want_o, want_S = wk_ref.wkv6(r.float(), k.float(), v.float(), lw, u, S0)
    assert o.dtype == dtype and S.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o, **WKV_TOL[dtype])
    torch.testing.assert_close(S, want_S, **WKV_TOL[torch.float32])
    o2, S2 = wk_ops.wkv6(r, k, v, lw, u, S0)
    assert torch.equal(o, o2) and torch.equal(S, S2)


@pytest.mark.cuda
def test_wkv6_kernel_reads_strided_projections(cuda_device):
    """The model hands (B, T, H, N) projections over as transposed views
    and reads the output back through the same transpose."""
    rng = np.random.default_rng(1)
    r, k, v = (torch.from_numpy(0.5 * rng.normal(size=(2, 37, 3, 64)))
               .to(cuda_device, torch.float32) for _ in range(3))
    lw = torch.from_numpy(-rng.uniform(0.01, 2.5, (2, 37, 3, 64))).to(
        cuda_device, torch.float32)
    u = torch.from_numpy(0.2 * rng.normal(size=(3, 64))).to(
        cuda_device, torch.float32)
    views = [x.transpose(1, 2) for x in (r, k, v, lw)]
    o, S = wk_ops.wkv6(*views, u)
    assert o.transpose(1, 2).is_contiguous()
    want_o, want_S = wk_ref.wkv6(*(x.contiguous() for x in views), u)
    torch.testing.assert_close(o, want_o, **WKV_TOL[torch.float32])
    torch.testing.assert_close(S, want_S, **WKV_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", LRU_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_kernel_on_card(cuda_device, b, s, w, with_h0):
    rng = np.random.default_rng(s + w)
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, w))).to(
        cuda_device, torch.float32)
    x = torch.from_numpy(0.1 * rng.normal(size=(b, s, w))).to(
        cuda_device, torch.float32)
    h0 = (torch.from_numpy(rng.normal(size=(b, w))).to(
        cuda_device, torch.float32) if with_h0 else None)
    before = lru_ops.lru_scan.launches
    h, last = lru_ops.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert lru_ops.lru_scan.launches == before + 1
    want_h, want_last = lru_ref.lru_scan(a, x, h0)
    torch.testing.assert_close(h, want_h, **LRU_TOL)
    torch.testing.assert_close(last, want_last, **LRU_TOL)
    h2, last2 = lru_ops.lru_scan(a, x, h0)
    assert torch.equal(h, h2) and torch.equal(last, last2)
