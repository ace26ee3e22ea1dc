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
