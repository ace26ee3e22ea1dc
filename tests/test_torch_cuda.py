"""The port's CUDA kernels against their plain versions, on the card only.

Imports torch and numpy alone, so that it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips.
"""
import dataclasses
import os

import numpy as np
import pytest

# cuBLAS reads its workspace setting at its first use in the process: the
# deterministic train-replay test below needs the reproducible one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.moe_rows import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_rows import ref as moe_ref  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ops as pa_ops  # noqa: E402
from repro_torch.kernels.pairwise_affinity import ref as pa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wk_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wk_ref  # noqa: E402

# the shapes of tests/test_kernels.py, a large B1 case and olmo-1b's prefill
# buckets; the JAX tests' fp32 and pairwise limits.  bf16: the kernel rounds
# the output to bf16 once and, on the tensor cores, each probability P to
# bf16 before the PV product (at most 2^-9 absolute, |P| <= 1), where the
# plain version keeps P in fp32; the limit stays one bf16 ulp of the
# output (<= 2^-7 |x|) over a 4e-3 floor.
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
# the edges of the bf16 tensor-core tiles: Bq = 64 or 128 query rows, Bk =
# 128 keys at D = 64 and 64 above; (Sq, Sk) at 1, Bq - 1, Bq + 1 and 3055.
# The kernel takes Bq = 128 (D <= 128 only) where its grid covers every SM,
# so the Bq = 128 cases run one head per SM and the Bq = 64 cases four heads
FA_TC_EDGES = [(d, bq, s) for d in (64, 128, 256)
               for bq in ((64, 128) if d <= 128 else (64,))
               for s in (1, bq - 1, bq + 1, 3055)]
# (Sq = Sk, causal, window) whose output must not depend on Bq
FA_BQ_CASES = [(200, True, 0), (200, False, 0), (700, True, 37),
               (3055, True, 2048)]
# (B, H, KV, Sq, Sk, D, causal, window): GQA groups 1, 2, 4 and 10 (MQA),
# and the decoder-only families' 2 at D = 64 (granite-moe-1b), 7
# (deepseek-coder-33b), 12 (command-r-plus-104b) and 48 (granite-20b's
# MQA); window 1, one under Bk, one off the tile grid and 2048 past its
# end; bidirectional with a ragged Sk on either side of Sq
FA_TC_CASES = [
    (1, 16, 8, 300, 300, 64, True, 0), (1, 56, 8, 257, 257, 128, True, 0),
    (1, 96, 8, 200, 200, 128, True, 0), (1, 48, 1, 300, 300, 128, True, 0),
    (1, 14, 2, 130, 77, 128, False, 0),
    (2, 2, 2, 200, 200, 128, True, 0), (1, 4, 2, 300, 300, 64, True, 0),
    (1, 8, 2, 257, 257, 128, True, 0), (1, 10, 1, 333, 333, 256, True, 0),
    (1, 4, 2, 300, 300, 128, True, 1), (1, 4, 1, 300, 300, 256, True, 1),
    (1, 4, 2, 300, 300, 64, True, 37), (1, 10, 1, 500, 500, 256, True, 37),
    (1, 4, 2, 700, 700, 128, True, 200), (1, 10, 1, 700, 700, 256, True, 200),
    (1, 10, 1, 3055, 3055, 256, True, 2048),
    (1, 4, 4, 2300, 2300, 128, True, 2048),
    (2, 4, 2, 130, 77, 128, False, 0), (1, 4, 1, 130, 200, 256, False, 0),
    (1, 2, 2, 65, 3055, 64, False, 0),
]
# the bf16 kernel's chunk: S = 1, under, at and past one chunk, the serve
# path's longest prompt; B > 1
LRU_CHUNK_SHAPES = [(1, 1, 2560), (2, 57, 300), (3, 128, 256),
                    (2, 129, 130), (1, 3055, 2560), (4, 500, 96)]
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


def _qkv_on(dev, b, h, kv, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev, dtype)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))


def _check_flash(q, k, v, **kw):
    """The kernel against its plain version, and a second launch gives the
    same bits."""
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.attention(q, k, v, causal=kw.get("causal", True),
                            window=kw.get("window", 0))
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[q.dtype])
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, **kw))


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("d,bq,s", FA_TC_EDGES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_tile_edges(cuda_device, d, bq, s, causal):
    h = 4 if bq == 64 else _sm_count() + _sm_count() % 2
    q, k, v = _qkv_on(cuda_device, 1, h, h // 2, s, s, d, torch.bfloat16,
                      s + d)
    if bq == 128:   # the grid covers every SM: the kernel takes Bq = 128
        assert -(-s // 128) * h >= _sm_count()
    _check_flash(q, k, v, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,window", FA_BQ_CASES)
def test_flash_tensor_core_block_sizes_give_same_bits(cuda_device, d, s,
                                                      causal, window):
    """Four heads give a grid under the SM count (Bq = 64); the same heads
    repeated over the batch until the grid covers every SM run at
    Bq = 128, and each copy must give the same bits."""
    q, k, v = _qkv_on(cuda_device, 1, 4, 2, s, s, d, torch.bfloat16, s + d)
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    reps = -(-_sm_count() // (-(-s // 128) * 4))
    assert reps > 1
    wide = fa_ops.flash_attention(*(x.repeat(reps, 1, 1, 1)
                                    for x in (q, k, v)),
                                  causal=causal, window=window)
    torch.cuda.synchronize()
    for i in range(reps):
        assert torch.equal(wide[i:i + 1], got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", FA_TC_CASES)
def test_flash_tensor_core_cases(cuda_device, b, h, kv, sq, sk, d, causal,
                                 window):
    q, k, v = _qkv_on(cuda_device, b, h, kv, sq, sk, d, torch.bfloat16,
                      sq + sk + window)
    _check_flash(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
def test_flash_tensor_core_refuses_misaligned_views(cuda_device):
    """TMA needs 16-byte aligned bases and strides: the wrapper raises, it
    does not fall back."""
    q, k, v = _qkv_on(cuda_device, 1, 2, 2, 64, 64, 64, torch.bfloat16, 0)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(q.shape)                 # base off by 2 bytes
    wide = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16,
                       device=cuda_device)[..., :64]  # seq stride 136 bytes
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            fa_ops.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="16-byte"):
            fa_ops.flash_attention(q, bad, v)
    # fp32 copies a view off the 16-byte grid (its tiles come in by
    # cp.async), so it takes any head-contiguous view
    wide32 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 2, 64, 66)).astype(np.float32)).to(cuda_device)[..., :64]
    got = fa_ops.flash_attention(wide32, k.float(), v.float())
    want = fa_ref.attention(wide32.contiguous(), k.float(), v.float())
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


# ---------------------------------------------------------------------------
# B2's fp32 kernels: split TF32 on the tensor cores (csrc/tf32.cuh)
# ---------------------------------------------------------------------------

# the fp32 tiles' edges: 64 query rows a block (forward, dQ pass), 64 or 32
# keys a K/V tile in two halves (forward), 64 or 16 keys (dQ pass), 64 or
# 16 queries a dK/dV tile
FA_FP32_EDGE_S = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", FA_FP32_EDGE_S)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fp32_tile_edges(cuda_device, d, s, causal):
    q, k, v = _qkv_on(cuda_device, 1, 4, 2, s, s, d, torch.float32, s + d)
    _check_flash(q, k, v, causal=causal)
    if causal:
        _check_flash_bwd(q, k, v, _do_like(q, s), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", FA_TC_CASES)
def test_flash_fp32_cases(cuda_device, b, h, kv, sq, sk, d, causal, window):
    """The bf16 kernel's GQA, MQA, window and Sq != Sk cases in fp32, forward
    and backward, at the fp32 limit."""
    q, k, v = _qkv_on(cuda_device, b, h, kv, sq, sk, d, torch.float32,
                      sq + sk + window)
    _check_flash(q, k, v, causal=causal, window=window)
    _check_flash_bwd(q, k, v, _do_like(q, sq), causal, window)


@pytest.mark.cuda
def test_fp32_runs_the_split_tf32_kernels(cuda_device):
    """An fp32 call launches the tensor-core kernels (their names, in a
    profile of one forward and one backward), and no other attention
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _qkv_on(cuda_device, 1, 4, 2, 200, 200, 128, torch.float32, 4)
    do = _do_like(q, 5)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
        fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_time_total > 0}
    flash = {n for n in names if "flash" in n}
    for want in ("flash_fwd_split", "flash_bwd_dq_split",
                 "flash_bwd_dkdv_split", "flash_bwd_delta"):
        assert any(want in n for n in flash), (want, flash)
    assert all("_split<" in n or "flash_bwd_delta" in n for n in flash), flash


@pytest.mark.cuda
def test_tf32_rounding_matches_cvt_rna(cuda_device):
    """The fp32 kernels round their operands' hi parts with two integer ops
    (tf32::rna): the bits of cvt.rna.tf32.f32 for every non-NaN input; and
    ``ref.tf32_round`` (the CPU emulation's rounding) gives the card's bits
    for every input, NaNs included, on 2^20 seeded patterns and edges."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").flash_tf32_round
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    edges = [0x00000001, 0x00001000, 0x007FFFFF, 0x3F801000, 0xBF801000,
             0x7F7FEFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0x7F800001,
             0x7FFFFFFF, 0xFFC00000]
    bits = np.concatenate([np.random.default_rng(0).integers(
        0, 2 ** 32, 1 << 20, dtype=np.uint64), edges]).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.int32).copy())
    xc = x.to(cuda_device).view(torch.float32)
    cvt, rna = torch.empty_like(xc), torch.empty_like(xc)
    assert fn(xc.data_ptr(), cvt.data_ptr(), rna.data_ptr(), xc.numel(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    cvt, rna = cvt.view(torch.int32).cpu(), rna.view(torch.int32).cpu()
    finite = ~torch.isnan(x.view(torch.float32))
    assert torch.equal(rna[finite], cvt[finite])
    assert torch.equal(fa_ref.tf32_round(x.view(torch.float32))
                       .view(torch.int32), cvt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", LRU_CHUNK_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_chunk_edges_on_card(cuda_device, b, s, w, with_h0):
    rng = np.random.default_rng(s + w + b)
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, w))).to(
        cuda_device, torch.float32)
    x = torch.from_numpy(0.1 * rng.normal(size=(b, s, w))).to(
        cuda_device, torch.float32)
    h0 = (torch.from_numpy(rng.normal(size=(b, w))).to(
        cuda_device, torch.float32) if with_h0 else None)
    h, last = lru_ops.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    for want_h, want_last in (lru_ref.lru_scan(a, x, h0),
                              lru_ref.lru_scan_chunked(a, x, h0,
                                                       lru_ops.CHUNK)):
        torch.testing.assert_close(h, want_h, **LRU_TOL)
        torch.testing.assert_close(last, want_last, **LRU_TOL)
    h2, last2 = lru_ops.lru_scan(a, x, h0)
    assert torch.equal(h, h2) and torch.equal(last, last2)


# B3 as a chunk-parallel scan: T at the chunk edges (0, 1, L - 1, L, L + 1,
# 2L + 1), rwkv6's longest serve prompt and a long one; B = 1 and 3
WKV_CHUNK_T = [0, 1, wk_ops.CHUNK - 1, wk_ops.CHUNK, wk_ops.CHUNK + 1,
               2 * wk_ops.CHUNK + 1, 370, 3000]
# the model's clamp of log_w: its two ends (the widest exponents a chunk
# can see, and decay ~1) and uniform between them
WKV_FILLS = ["uniform", "min", "max"]


def _wkv_on(dev, b, h, t, n, dtype, with_s0, fill, seed, layout="bhtn"):
    """Seeded inputs on the card; ``layout="bthn"`` gives r, k, v, log_w as
    (B, H, T, N) views of (B, T, H, N) tensors, as the model passes them."""
    rng = np.random.default_rng(seed)
    shape = (b, h, t, n) if layout == "bhtn" else (b, t, h, n)
    r, k, v = (0.5 * rng.normal(size=shape) for _ in range(3))
    lw = {"uniform": -rng.uniform(0.01, 2.5, shape),
          "min": np.full(shape, -2.5), "max": np.full(shape, -1e-4)}[fill]
    r, k, v, lw = (torch.from_numpy(x).to(dev, torch.float32)
                   for x in (r, k, v, lw))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    if layout == "bthn":
        r, k, v, lw = (x.transpose(1, 2) for x in (r, k, v, lw))
    u = torch.from_numpy(0.2 * rng.normal(size=(h, n))).to(
        dev, torch.float32)
    S0 = (torch.from_numpy(0.3 * rng.normal(size=(b, h, n, n))).to(
        dev, torch.float32) if with_s0 else None)
    return r, k, v, lw, u, S0


def _check_wkv6(r, k, v, lw, u, S0):
    """The kernel against the chunked and the sequential plain versions,
    evaluated in fp64 on the same rounded inputs (over thousands of tokens
    with decays near 1 the sequential fp32 form drifts past the fp32 limit
    itself), one launch a call, and a second call gives the same bits."""
    before = wk_ops.wkv6.launches
    o, S = wk_ops.wkv6(r, k, v, lw, u, S0)
    torch.cuda.synchronize()
    assert wk_ops.wkv6.launches == before + 1
    assert o.dtype == r.dtype and o.shape == r.shape
    assert S.dtype == torch.float32
    assert o.transpose(1, 2).is_contiguous()
    args = [x.double() for x in (r, k, v, lw, u)] + [
        None if S0 is None else S0.double()]
    for want_o, want_S in (wk_ref.wkv6_chunked(*args, chunk=wk_ops.CHUNK),
                           wk_ref.wkv6(*args)):
        torch.testing.assert_close(o.float(), want_o.float(),
                                   **WKV_TOL[r.dtype])
        torch.testing.assert_close(S, want_S.float(),
                                   **WKV_TOL[torch.float32])
    o2, S2 = wk_ops.wkv6(r, k, v, lw, u, S0)
    assert torch.equal(o, o2) and torch.equal(S, S2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", WKV_CHUNK_T)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_chunk_edges_on_card(cuda_device, t, b, n, dtype, with_s0):
    _check_wkv6(*_wkv_on(cuda_device, b, 2, t, n, dtype, with_s0, "uniform",
                         seed=t + n + b))


@pytest.mark.cuda
@pytest.mark.parametrize("t", WKV_CHUNK_T)
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("fill", ["min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_decay_extremes_on_card(cuda_device, t, n, fill, dtype):
    _check_wkv6(*_wkv_on(cuda_device, 3, 2, t, n, dtype, True, fill,
                         seed=t + n + 7))


@pytest.mark.cuda
@pytest.mark.parametrize("t", WKV_CHUNK_T)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_strided_projections_at_chunk_edges(cuda_device, t, dtype,
                                                 with_s0):
    _check_wkv6(*_wkv_on(cuda_device, 3, 5, t, 64, dtype, with_s0,
                         "uniform", seed=t + 11, layout="bthn"))


@pytest.mark.cuda
def test_wkv6_unaligned_views_are_copied(cuda_device):
    """Views whose bases or strides are off the kernel's 4-element grid
    (r and S0 here) are copied by the wrapper, with the same result as the
    aligned inputs."""
    r, k, v, lw, u, S0 = _wkv_on(cuda_device, 2, 3, 37, 64, torch.float32,
                                 True, "uniform", seed=5)
    flat = torch.zeros(r.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(r.shape)
    shifted.copy_(r)
    s_flat = torch.zeros(S0.numel() + 1, device=cuda_device)
    s_shifted = s_flat[1:].view(S0.shape)
    s_shifted.copy_(S0)
    _check_wkv6(shifted, k, v, lw, u, s_shifted)
    o, S = wk_ops.wkv6(r, k, v, lw, u, S0)
    o2, S2 = wk_ops.wkv6(shifted, k, v, lw, u, s_shifted)
    assert torch.equal(o, o2) and torch.equal(S, S2)


# B1 on register tiles: N around the 64 x 128 output tile and its float4
# columns, F across the 16-feature chunk
PA_TILE_N = [1, 63, 64, 65, 127, 128, 129, 4097]
PA_TILE_F = [1, 3, 10, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("n", PA_TILE_N)
@pytest.mark.parametrize("f", PA_TILE_F)
def test_pairwise_kernel_tile_edges(cuda_device, n, f):
    pts_np = np.random.default_rng(n + 101 * f).normal(size=(n, f)).astype(
        np.float32)
    pts = torch.from_numpy(pts_np).to(cuda_device)
    before = pa_ops.pairwise_distance.launches
    got = pa_ops.pairwise_distance(pts)
    torch.cuda.synchronize()
    assert pa_ops.pairwise_distance.launches == before + 1
    assert got.shape == (n, n) and got.dtype == torch.float32
    g = got.cpu().numpy()
    w = pa_ref.pairwise_distance(pts).cpu().numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(g[off], w[off], **PA_TOL)
    bound = np.sqrt(8 * np.finfo(np.float32).eps
                    * (pts_np.astype(np.float64) ** 2).sum(1))
    assert (np.abs(np.diag(g)) <= bound).all()
    assert torch.equal(got, pa_ops.pairwise_distance(pts))


# B1 at the planner's points: the CRCH plan's PCA projections of the four
# workflow types at the paper's largest size (700 tasks on 20 VMs; K = 1),
# where many tasks project to nearly the same point.  Off the cancellation
# bound the pairwise limit; inside it (the diagonal, near-coincident tasks)
# each side within the bound of the fp64 distance
PLANNER_KINDS = ("montage", "cybershake", "ligo", "sipht")


def _planner_points(kind, device):
    from repro_torch.core import (CloudEnvironment, fit_pca,
                                  generate_workflow, task_features)
    wf = generate_workflow(kind, 700, seed=1)
    env = CloudEnvironment(wf, 20, seed=2)
    return wf, env, fit_pca(task_features(wf, env), device=device).projected


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PLANNER_KINDS)
def test_pairwise_kernel_at_the_planner_points(cuda_device, kind):
    from repro_torch.core.clustering import distance_faults
    _, _, pts_np = _planner_points(kind, cuda_device)
    assert pts_np.shape[1] == 1
    pts = torch.from_numpy(pts_np.astype(np.float32)).to(cuda_device)
    before = pa_ops.pairwise_distance.launches
    got = pa_ops.pairwise_distance(pts)
    torch.cuda.synchronize()
    assert pa_ops.pairwise_distance.launches == before + 1
    want = pa_ref.pairwise_distance(pts)
    bad, _ = distance_faults(pts_np, got.cpu().numpy(), want.cpu().numpy())
    assert not bad.any(), np.argwhere(bad)[:10]
    assert torch.equal(got, pa_ops.pairwise_distance(pts))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PLANNER_KINDS)
def test_plan_on_card_against_plan_on_cpu(cuda_device, kind):
    """The card's plan (cuSOLVER SVD, B1) equals the CPU's (plain versions)
    or passes the near-tie rule; a repeated card plan is identical."""
    from repro_torch.core import CloudEnvironment, generate_workflow, plan
    from repro_torch.core.clustering import compare_merges
    wf = generate_workflow(kind, 700, seed=1)
    env = CloudEnvironment(wf, 20, seed=2)
    before = pa_ops.pairwise_distance.launches
    card = plan(wf, env, device=cuda_device)
    assert pa_ops.pairwise_distance.launches == before + 1
    cpu = plan(wf, env, device="cpu")
    verdict = compare_merges(card.clustering, cpu.clustering,
                             card.pca.projected, cpu.pca.projected)
    assert verdict.ok, verdict
    if verdict.verdict == "equal":
        np.testing.assert_array_equal(card.rep_counts, cpu.rep_counts)
    again = plan(wf, env, device=cuda_device)
    np.testing.assert_array_equal(again.rep_counts, card.rep_counts)
    assert again.clustering.merge_history == card.clustering.merge_history
    assert again.schedule.placements == card.schedule.placements
    assert again.ckpt_lambda == card.ckpt_lambda


# ---------------------------------------------------------------------------
# the flash-attention backward (B2) and a train step on the card
# ---------------------------------------------------------------------------

# each gradient against the plain backward in fp32 on the same inputs (o and
# lse from the forward kernel), normalised by max(1, its largest magnitude):
# fp32 at the JAX tests' limit; bf16 one bf16 ulp of the gradient (rtol
# 1e-2) over a floor of 4e-3 of that scale (the kernel computes in fp32 and
# rounds each gradient to bf16 once).  lse is fp32 on both sides
FA_BWD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
              torch.bfloat16: dict(atol=4e-3, rtol=1e-2)}
LSE_TOL = dict(atol=2e-4, rtol=2e-4)
# the 64-row tiles' edges
FA_BWD_EDGES = [(d, s) for d in (64, 128)
                for s in (1, 63, 64, 65, 127, 129, 2048)]
# (B, H, KV, S, D, causal, window): GQA groups 1, 2, 4, and the decoder-
# only families' 2 at D = 64, 7, 12 and 48; windows 1, 37 and 2048 (past
# the end of a 2100-token sequence's first tile rows); bidirectional
FA_BWD_CASES = [(1, 16, 8, 300, 64, True, 0), (1, 56, 8, 257, 128, True, 0),
                (1, 96, 8, 200, 128, True, 0), (1, 48, 1, 300, 128, True, 0),
                (1, 14, 2, 129, 128, False, 0),
                (2, 4, 4, 200, 128, True, 0), (2, 4, 2, 200, 128, True, 0),
                (2, 8, 2, 200, 64, True, 0), (1, 4, 2, 300, 64, True, 1),
                (1, 4, 2, 300, 128, True, 37),
                (1, 4, 4, 2100, 128, True, 2048),
                (2, 4, 2, 129, 128, False, 0), (1, 4, 1, 65, 64, False, 0)]


# (B, H, KV, Sq, Sk, D, causal) with Sq and Sk apart: whisper-small's
# cross-attention (12 heads of 64; decoder rows against 1500 frames, off
# the 64-key grid, so the last key tile is ragged) at a serve bucket's
# length and its 448-token training length, its bidirectional encoder, and
# smaller ragged cases on either side of Sq, GQA and D = 128 among them
FA_BWD_CROSS_CASES = [(1, 12, 12, 77, 1500, 64, False),
                      (2, 12, 12, 448, 1500, 64, False),
                      (1, 12, 12, 1500, 1500, 64, False),
                      (1, 4, 2, 130, 77, 128, False),
                      (2, 4, 4, 65, 200, 64, False),
                      (1, 8, 2, 1, 129, 128, False)]
# llava-next-mistral-7b: 576 image rows before 200 text positions, causal
# over both, 32 query heads of 128 on 8 KV heads
FA_LLAVA_SHAPE = (1, 32, 8, 576 + 200, 128)


def _check_flash_bwd(q, k, v, do, causal=True, window=0):
    kw = dict(causal=causal, window=window)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, fa_ops.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(lse, fa_ref.attention_lse(q, k, v, **kw),
                               **LSE_TOL)
    before = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == before + 1
    want = fa_ref.attention_backward(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.float() / scale, w / scale,
                                   **FA_BWD_TOL[q.dtype])
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _do_like(q, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=q.shape).astype(
        np.float32)).to(q.device, q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d,s", FA_BWD_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_tile_edges(cuda_device, d, s, dtype):
    q, k, v = _qkv_on(cuda_device, 1, 4, 2, s, s, d, dtype, s + d)
    _check_flash_bwd(q, k, v, _do_like(q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_cases(cuda_device, b, h, kv, s, d, causal, window,
                              dtype):
    q, k, v = _qkv_on(cuda_device, b, h, kv, s, s, d, dtype, s + window)
    _check_flash_bwd(q, k, v, _do_like(q, s + 1), causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", FA_BWD_CROSS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_cross_and_bidir_cases(cuda_device, b, h, kv, sq, sk,
                                              d, causal, dtype):
    q, k, v = _qkv_on(cuda_device, b, h, kv, sq, sk, d, dtype, sq + sk)
    _check_flash_bwd(q, k, v, _do_like(q, sk), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_llava_prefix_shape(cuda_device, dtype):
    """Forward and backward at llava-next's prefill shape, from the model's
    (B, S, H, D) projections as transposed views."""
    b, h, kv, s, d = FA_LLAVA_SHAPE
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to(cuda_device, dtype).transpose(1, 2)
        for n in (h, kv, kv))
    _check_flash(q, k, v, causal=True)
    _check_flash_bwd(q, k, v, _do_like(q, 6))


@pytest.mark.cuda
def test_flash_backward_at_the_train_main_path(cuda_device):
    """olmo-1b's training shape, (4, 16, 16, 2048, 128) bf16 causal, from
    the model's (B, S, H, D) projections as transposed views; dq, dk, dv
    come back as views of contiguous (B, S, H, D) buffers."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 2048, 16, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for _ in range(3))
    _check_flash_bwd(q, k, v, _do_like(q, 1))
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, o, lse, _do_like(q, 1))
    for g in (dq, dk, dv):
        assert g.transpose(1, 2).is_contiguous()


# (B, H, KV, S, D) of the training shapes of deepseek-coder-33b (GQA group
# 7), granite-20b (MQA, 48:1) and command-r-plus-104b (12) at global batch
# 4 x 2048 tokens
FA_BWD_TRAIN_SHAPES = [(4, 56, 8, 2048, 128), (4, 48, 1, 2048, 128),
                       (4, 96, 8, 2048, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", FA_BWD_TRAIN_SHAPES)
def test_flash_backward_at_the_large_decoders_train_shapes(cuda_device, b, h,
                                                           kv, s, d):
    """bf16 causal, from the model's (B, S, H, D) projections as transposed
    views, against the plain backward in fp32."""
    rng = np.random.default_rng(h + kv)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for n in (h, kv, kv))
    _check_flash_bwd(q, k, v, _do_like(q, h))


@pytest.mark.cuda
def test_flash_backward_refuses_an_unported_head_dim(cuda_device):
    """D = 32 has no kernel in either direction (the backward takes 64,
    128 and 256); o and lse come from the plain versions on the card."""
    q, k, v = _qkv_on(cuda_device, 1, 2, 1, 64, 64, 32, torch.bfloat16, 3)
    o = fa_ref.attention(q, k, v)
    lse = fa_ref.attention_lse(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse, o)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.attention(q.requires_grad_(), k, v)


@pytest.mark.cuda
def test_flash_backward_refuses_misaligned_views(cuda_device):
    """The bf16 backward reads q, k, v and dO by TMA: a q, k, v or o off the
    16-byte grid raises (no fallback); a dO off it is copied, with the same
    bits as the aligned dO; fp32 copies such views (cp.async) and gives the
    aligned views' bits."""
    q, k, v = _qkv_on(cuda_device, 1, 2, 2, 64, 64, 64, torch.bfloat16, 7)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    do = _do_like(q, 8)

    def shifted(x):   # the same values at a base 2 bytes off
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = flat[1:].view(x.shape)
        out.copy_(x)
        return out

    def wide(x):      # the same values at a seq stride of 136 bytes
        out = torch.zeros(x.shape[:-1] + (x.shape[-1] + 4,), dtype=x.dtype,
                          device=x.device)[..., :x.shape[-1]]
        out.copy_(x)
        return out

    for bad in (shifted, wide):
        for i in range(4):
            args = [q, k, v, o]
            args[i] = bad(args[i])
            with pytest.raises(ValueError, match="16-byte"):
                fa_ops.flash_attention_bwd(*args, lse, do)
    want = fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    for bad in (shifted, wide):
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, bad(do))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    qf, kf, vf = (x.float() for x in (q, k, v))
    of, lsef = fa_ops.flash_attention(qf, kf, vf, return_lse=True)
    got = fa_ops.flash_attention_bwd(wide(qf), kf, vf, of, lsef,
                                     shifted(do.float()))
    want = fa_ops.flash_attention_bwd(qf, kf, vf, of, lsef, do.float())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_both_kernels(cuda_device, dtype):
    q, k, v = (x.requires_grad_() for x in _qkv_on(
        cuda_device, 2, 4, 2, 150, 150, 64, dtype, 5))
    do = _do_like(q, 6)
    fwd = fa_ops.flash_attention.launches
    bwd = fa_ops.flash_attention_bwd.launches
    out = fa_ops.attention(q, k, v)
    out.backward(do)
    assert fa_ops.flash_attention.launches == fwd + 1
    assert fa_ops.flash_attention_bwd.launches == bwd + 1
    o, lse = fa_ops.flash_attention(q.detach(), k.detach(), v.detach(),
                                    return_lse=True)
    want = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o,
                                      lse, do)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)


def _card_train_cfg():
    """The tiny olmo widened to head dim 64 (the backward kernel's
    smallest), in fp32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmo-1b", tiny=True), d_model=128,
                               n_heads=2, n_kv_heads=2, head_dim=64,
                               compute_dtype="float32")


def _card_train_params(cfg, device):
    from repro_torch.models import lm
    gen = torch.Generator(device="cpu").manual_seed(0)
    return lm.init_params(cfg, gen, device=device)


@pytest.mark.cuda
def test_tiny_train_step_on_card_matches_cpu(cuda_device):
    """Three fp32 train steps from the same init on the same batches: the
    card (both flash kernels, cuBLAS in full fp32) against the CPU (plain
    versions), losses and final params at the fp32 limit."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten
    cfg = _card_train_cfg()
    pipe = SyntheticTokenPipeline(DataConfig(2, 96, seed=3), cfg)
    step = make_train_step(cfg, q_chunk=96, xent_chunk=32, warmup=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _card_train_params(cfg, dev)
        state = adamw_init(params)
        fwd = fa_ops.flash_attention.launches
        bwd = fa_ops.flash_attention_bwd.launches
        losses = []
        for i in range(3):
            params, state, m = step(params, state, pipe.batch_at(i))
            losses.append(float(m["loss"]))
        launched = (fa_ops.flash_attention.launches - fwd,
                    fa_ops.flash_attention_bwd.launches - bwd)
        runs[dev] = (losses, params, launched)
    assert runs["cpu"][2] == (0, 0)
    # remat: the forward runs twice a layer per step
    assert runs["cuda"][2] == (3 * 2 * cfg.n_layers, 3 * cfg.n_layers)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                               atol=2e-4, rtol=2e-4)
    for (name, a), (_, b) in zip(flatten(runs["cuda"][1]),
                                 flatten(runs["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-4,
                                   msg=str(name))


@pytest.mark.cuda
def test_tiny_whisper_on_card_matches_cpu(cuda_device):
    """The tiny whisper (head dim 64) in fp32, from the same init: three
    train steps on the pipeline's batches with their frames (bidirectional,
    causal and cross B2, forward and backward), then a prefill with its
    cross K/V and two decode steps, the card against the CPU at the fp32
    limit."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(get_config("whisper-small", tiny=True),
                              compute_dtype="float32")
    pipe = SyntheticTokenPipeline(DataConfig(2, 40, seed=3), cfg)
    step = make_train_step(cfg, xent_chunk=16, warmup=1)
    batch = pipe.batch_at(9)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _card_train_params(cfg, dev)
        state = adamw_init(params)
        fwd = fa_ops.flash_attention.launches
        losses = []
        for i in range(3):
            params, state, m = step(params, state, pipe.batch_at(i))
            losses.append(float(m["loss"]))
        pre = {"tokens": torch.from_numpy(batch["tokens"]).to(dev),
               "frames": torch.from_numpy(batch["frames"]).to(dev)}
        logits, cache = lm.prefill(params, cfg, pre, 48)
        steps = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for i in range(2):
            logits, cache = lm.decode_step(params, cfg, cache, tok, 40 + i)
            steps.append(logits)
        runs[dev] = (losses, params, torch.stack(steps).cpu(), cache,
                     fa_ops.flash_attention.launches - fwd)
    assert runs["cpu"][4] == 0 and runs["cuda"][4] > 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                               atol=2e-4, rtol=2e-4)
    for (name, a), (_, b) in zip(flatten(runs["cuda"][1]),
                                 flatten(runs["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-4,
                                   msg=str(name))
    torch.testing.assert_close(runs["cuda"][2], runs["cpu"][2], atol=2e-4,
                               rtol=2e-4)
    for name in ("cross_k", "cross_v", "k", "v"):
        torch.testing.assert_close(runs["cuda"][3][name].cpu(),
                                   runs["cpu"][3][name], atol=2e-4,
                                   rtol=2e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 200, 2048])
def test_moe_layer_on_card_matches_cpu_and_repeats_its_bits(cuda_device, s):
    """granite-moe-1b's MoE layer at its published widths (32 experts,
    top 8) on one sequence (s = 1: a decode group of 4 rows) in fp32: the
    card's output, aux and gradients against the CPU's at the fp32 limit,
    and a second backward under deterministic algorithms with the same
    bits (the routing gathers; no atomics).  The tokens are drawn with a
    margin of 1e-5 between their 8th and 9th router probabilities: the two
    devices' fp32 products may round a closer pair the other way."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = layers.init_moe(gen, cfg)
    b = 4 if s == 1 else 1
    x = torch.randn((2 * b * s, cfg.d_model), generator=gen)
    top = torch.softmax(x @ p["router"], -1).sort(-1, descending=True)[0]
    x = x[top[:, 7] - top[:, 8] > 1e-5][:b * s].reshape(b, s, -1)
    dout = torch.randn((b, s, cfg.d_model), generator=gen)

    def run(dev):
        pp = {k: v.detach().to(dev, copy=True).requires_grad_()
              for k, v in p.items()}
        xx = x.to(dev, copy=True).requires_grad_()
        out, aux = layers.moe_forward(pp, xx, cfg)
        (out * dout.to(dev)).sum().add(0.5 * aux).backward()
        return [out, aux, xx.grad] + [pp[k].grad for k in sorted(pp)]

    want = run("cpu")
    torch.use_deterministic_algorithms(True)
    try:
        got, again = run("cuda"), run("cuda")
    finally:
        torch.use_deterministic_algorithms(False)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.detach().cpu(), w.detach(), atol=2e-4,
                                   rtol=2e-4)


# the MoE layer's row kernels: (groups, tokens a group, k, experts,
# capacity factor, d) at granite-moe-1b's widths (top 8 of 32, d 1024) and
# phi3.5-moe's (top 2 of 16, d 4096), two 2048-token groups; capacity
# drops at factor 0.3; a decode group of 4 rows; rows off the 16-byte grid
# (d 998: the kernels' element-at-a-time instance, both dtypes)
MOE_ROW_CASES = {"odd_width": (2, 64, 3, 8, 1.0, 998),
                 "granite": (2, 2048, 8, 32, 1.25, 1024),
                 "granite_drops": (2, 2048, 8, 32, 0.3, 1024),
                 "granite_decode": (1, 4, 8, 32, 1.25, 1024),
                 "phi35": (2, 2048, 2, 16, 1.25, 4096),
                 "phi35_drops": (2, 2048, 2, 16, 0.3, 4096),
                 "phi35_decode": (1, 4, 2, 16, 1.25, 4096)}


def _moe_routes(g_count, g, k, e, cf, gen):
    """Index maps as ``layers._moe`` builds them (random router
    probabilities, top k, token-major slots, drops past the capacity):
    slot (n_tok, k), token_at and pair_at (n_slot,), gates (G, g, k)."""
    import math
    import torch.nn.functional as F
    probs = torch.rand((g_count, g, e), generator=gen)
    gate_idx = probs.argsort(-1, descending=True)[..., :k]
    cap = max(int(math.ceil(g * k / e * cf)), 4)
    onehot = F.one_hot(gate_idx, e)
    seen = onehot.reshape(g_count, g * k, e).cumsum(1).reshape(onehot.shape)
    pos = (seen * onehot).sum(-1) - 1
    n_tok, n_slot = g_count * g, e * g_count * cap
    group = torch.arange(g_count)[:, None, None]
    slot = torch.where(pos < cap, (gate_idx * g_count + group) * cap + pos,
                       n_slot).reshape(n_tok, k)
    kept = slot.reshape(-1) < n_slot
    pairs = torch.arange(n_tok * k)[kept]
    pair_at = torch.full((n_slot,), n_tok * k, dtype=torch.int64)
    pair_at[slot.reshape(-1)[kept]] = pairs
    token_at = torch.where(pair_at < n_tok * k, pair_at // k, n_tok)
    gates = torch.rand((g_count, g, k), generator=gen) + 0.05
    return slot, token_at, pair_at, gates / gates.sum(-1, keepdim=True)


def _moe_row_outputs(x, ye, dxe, g, gates, slot, token_at, pair_at):
    """The four entry points' outputs: the kernels' and the plain
    version's (its gradients by autograd)."""
    n_tok, k = slot.shape
    w = gates.sum(-1).reshape(-1)
    d_ye, d_w = moe_ops.combine_bwd(g, ye, w, slot, token_at)
    got = {"xe": moe_ops.dispatch_fwd(x, token_at),
           "out": moe_ops.combine_fwd(ye, slot, w), "d_ye": d_ye,
           "d_w": d_w, "dx": moe_ops.dispatch_bwd(dxe, slot)}
    xr, yr, gr = (t.detach().clone().requires_grad_() for t in (x, ye, gates))
    xe = moe_ref.dispatch(xr, slot, token_at)
    out = moe_ref.combine(yr, gr, slot, pair_at)
    torch.autograd.backward([xe, out], [dxe, g.reshape(out.shape)])
    want = {"xe": xe, "out": out.reshape(n_tok, -1), "d_ye": yr.grad,
            "d_w": gr.grad.reshape(n_tok, k)[:, 0], "dx": xr.grad}
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_ROW_CASES))
def test_moe_row_kernels_match_the_plain_version(cuda_device, case, dtype):
    """Each entry point against the plain version on the card: the
    gathers (dispatch, the combine's d_ye) to the bit; the sums in fp32
    within its rounding (the combine and dispatch backward: one rounding
    to bf16 may land one ulp apart; d_w: 1e-5 of the sum of its terms'
    magnitudes); a second run under deterministic algorithms gives the
    same bits."""
    g_count, g, k, e, cf, d = MOE_ROW_CASES[case]
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    maps = _moe_routes(g_count, g, k, e, cf, gen)
    slot, token_at, pair_at, gates = (t.cuda() for t in maps)
    n_tok, n_slot = slot.shape[0], token_at.shape[0]
    if case.endswith("drops"):
        assert int((slot == n_slot).sum()) > 0
    x, ye, dxe, gy = (torch.randn(shape, generator=gen).to(dt).cuda()
                      for shape in ((n_tok, d), (n_slot, d), (n_slot, d),
                                    (n_tok, d)))
    launches = [f.launches for f in (moe_ops.dispatch_fwd,
                                     moe_ops.combine_fwd, moe_ops.combine_bwd,
                                     moe_ops.dispatch_bwd)]
    got, want = _moe_row_outputs(x, ye, dxe, gy, gates, slot, token_at,
                                 pair_at)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(
        (moe_ops.dispatch_fwd, moe_ops.combine_fwd, moe_ops.combine_bwd,
         moe_ops.dispatch_bwd), launches)] == [1, 1, 1, 1]
    for name in ("xe", "d_ye"):
        assert torch.equal(got[name], want[name]), name
    tol = (dict(atol=2e-6, rtol=1e-5) if dt == torch.float32
           else dict(atol=1e-5, rtol=2 ** -7))
    for name in ("out", "dx"):
        torch.testing.assert_close(got[name], want[name], msg=name, **tol)
    ye_rows = torch.cat([ye, torch.zeros_like(ye[:1])]).float()[slot]
    terms = (gy.float()[:, None, :] * ye_rows).abs().sum((1, 2))
    err = (got["d_w"] - want["d_w"]).abs()
    assert bool((err <= 1e-5 * terms + 1e-6).all()), float(err.max())
    torch.use_deterministic_algorithms(True)
    try:
        again, _ = _moe_row_outputs(x, ye, dxe, gy, gates, slot, token_at,
                                    pair_at)
    finally:
        torch.use_deterministic_algorithms(False)
    for name in got:
        assert torch.equal(got[name], again[name]), name


@pytest.mark.cuda
def test_moe_train_step_runs_the_row_kernels(cuda_device):
    """One bf16 train step of a small MoE preset (granite-moe's tiny
    config at head dim 64) launches each row kernel once a layer a pass:
    dispatch and combine forward twice a layer (remat recomputes the
    forward), their backwards once."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", tiny=True),
                              d_model=128, n_heads=2, n_kv_heads=2,
                              head_dim=64, compute_dtype="bfloat16")
    assert cfg.remat
    step = make_train_step(cfg, q_chunk=96, xent_chunk=32, warmup=1)
    params = _card_train_params(cfg, cuda_device)
    state = adamw_init(params)
    batch = SyntheticTokenPipeline(DataConfig(2, 96, seed=3), cfg).batch_at(0)
    entries = (moe_ops.dispatch_fwd, moe_ops.combine_fwd,
               moe_ops.combine_bwd, moe_ops.dispatch_bwd)
    before = [f.launches for f in entries]
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert [f.launches - b for f, b in zip(entries, before)] == [
        2 * n, 2 * n, n, n]
    assert np.isfinite(float(m["loss"]))


@pytest.mark.cuda
def test_train_replay_after_a_crash_is_bit_identical_on_card(cuda_device,
                                                             tmp_path):
    """The coordinator with a forced crash against a fault-free run of the
    same steps, in bf16 with deterministic kernels: the same bits."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.ft import (CheckpointStore, DynamicInterval,
                                FaultInjector, TrainingCoordinator)
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(_card_train_cfg(), compute_dtype="bfloat16")
    step = make_train_step(cfg, q_chunk=96, xent_chunk=32, warmup=1)
    torch.use_deterministic_algorithms(True)
    try:
        finals = []
        for name, crash in (("clean", None), ("crash", {4: 1})):
            params = _card_train_params(cfg, cuda_device)
            inj = None
            if crash:
                inj = FaultInjector(mtbf_steps=100.0, seed=0,
                                    horizon_steps=0)
                inj.fail_steps = crash
            coord = TrainingCoordinator(
                train_step=step, params=params, opt_state=adamw_init(params),
                pipeline=SyntheticTokenPipeline(DataConfig(2, 96), cfg),
                store=CheckpointStore(str(tmp_path / name)),
                interval=DynamicInterval(gamma_s=1.0, lam_min=3.0,
                                         lam_max=3.0),
                injector=inj)
            rep = coord.run(6)
            assert rep.steps_completed == 6
            assert rep.restores == rep.failures == (1 if crash else 0)
            finals.append(coord.params)
    finally:
        torch.use_deterministic_algorithms(False)
    for (name, a), (_, b) in zip(flatten(finals[0]), flatten(finals[1])):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the backward kernels of the recurrent families' training
# ---------------------------------------------------------------------------

# B2 at D = 256 (bf16 on the tensor cores in 64-row tiles, with a dV pass
# and a dK pass; fp32 split TF32 with 16-key dQ tiles and 16-query dK/dV
# tiles): recurrentgemma's
# 10 query heads on one KV head under windows 1, 37, 200 and 2048 (the
# model's, past a 2100-token sequence's first rows), and both tiles' edges
FA_BWD_256_CASES = [(1, 10, 1, 300, 256, True, 1),
                    (1, 10, 1, 333, 256, True, 37),
                    (2, 10, 1, 700, 256, True, 200),
                    (1, 10, 1, 2100, 256, True, 2048),
                    (1, 4, 2, 129, 256, True, 0),
                    (1, 4, 1, 65, 256, False, 0)]
FA_BWD_256_EDGES = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FA_BWD_256_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_d256_cases(cuda_device, b, h, kv, s, d, causal,
                                   window, dtype):
    q, k, v = _qkv_on(cuda_device, b, h, kv, s, s, d, dtype, s + window)
    _check_flash_bwd(q, k, v, _do_like(q, s + 2), causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("s", FA_BWD_256_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_d256_tile_edges(cuda_device, s, dtype):
    q, k, v = _qkv_on(cuda_device, 1, 10, 1, s, s, 256, dtype, s)
    _check_flash_bwd(q, k, v, _do_like(q, s), True, 16)


@pytest.mark.cuda
def test_flash_backward_d256_refuses_misaligned_bf16(cuda_device):
    """bf16 at D = 256 reads q, k, v and o by TMA: a view off the 16-byte
    grid raises, with no SIMT fallback."""
    q, k, v = _qkv_on(cuda_device, 1, 10, 1, 96, 96, 256, torch.bfloat16, 9)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, window=37)
    for i in range(4):
        args = [q, k, v, o]
        flat = torch.zeros(args[i].numel() + 1, dtype=torch.bfloat16,
                           device=cuda_device)
        args[i] = flat[1:].view(args[i].shape).copy_(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            fa_ops.flash_attention_bwd(*args, lse, _do_like(q, 10),
                                       window=37)


@pytest.mark.cuda
def test_flash_backward_d256_through_autograd(cuda_device):
    """recurrentgemma's local attention as the model calls it: (B, S, H, D)
    projection views, window, bf16; both kernels launched, the gradients
    those of the wrapper's backward, bit for bit."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 300, n, 256)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).requires_grad_()
        for n in (10, 1, 1))
    do = _do_like(q.transpose(1, 2), 5)
    bwd = fa_ops.flash_attention_bwd.launches
    out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), window=64)
    out.backward(do)
    assert fa_ops.flash_attention_bwd.launches == bwd + 1
    for x in (q, k, v):
        assert x.grad.is_contiguous()
    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    o, lse = fa_ops.flash_attention(qt, kt, vt, window=64, return_lse=True)
    want = fa_ops.flash_attention_bwd(qt, kt, vt, o, lse, do, window=64)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g.transpose(1, 2), w)


# B4's backward against the plain backward (fp32 on both sides, gradients
# normalised by max(1, their largest magnitude)): the 128-step chunks'
# edges and recurrentgemma's training width; with h0 and dh_last (the
# serve-side arguments) and without (the model's)
LRU_BWD_SHAPES = [(1, 1, 2560), (2, 57, 300), (3, 128, 256), (2, 129, 130),
                  (1, 3055, 2560), (2, 4096, 256)]


def _lru_bwd_inputs(dev, b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, w))).to(
        dev, torch.float32)
    x = torch.from_numpy(0.1 * rng.normal(size=(b, s, w))).to(
        dev, torch.float32)
    h0 = torch.from_numpy(rng.normal(size=(b, w))).to(dev, torch.float32)
    dh = torch.from_numpy(rng.normal(size=(b, s, w))).to(dev, torch.float32)
    dl = torch.from_numpy(rng.normal(size=(b, w))).to(dev, torch.float32)
    return a, x, h0, dh, dl


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", LRU_BWD_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_backward_on_card(cuda_device, b, s, w, with_h0):
    a, x, h0, dh, dl = _lru_bwd_inputs(cuda_device, b, s, w, b + s + w)
    h0, dl = (h0, dl) if with_h0 else (None, None)
    h, _ = lru_ops.lru_scan(a, x, h0)
    before = lru_ops.lru_scan_bwd.launches
    got = lru_ops.lru_scan_bwd(a, h, dh, dl, h0)
    torch.cuda.synchronize()
    assert lru_ops.lru_scan_bwd.launches == before + 1
    want = lru_ref.lru_scan_backward(a, h, dh, dl, h0)
    assert (got[2] is None) == (not with_h0)
    for g, wnt in zip(got, want):
        if wnt is None:
            continue
        scale = max(1.0, float(wnt.abs().max()))
        torch.testing.assert_close(g / scale, wnt / scale, **LRU_TOL)
    again = lru_ops.lru_scan_bwd(a, h, dh, dl, h0)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))


@pytest.mark.cuda
def test_lru_scan_autograd_launches_both_kernels(cuda_device):
    a, x, h0, dh, _ = _lru_bwd_inputs(cuda_device, 2, 300, 256, 9)
    a, x, h0 = (t.requires_grad_() for t in (a, x, h0))
    fwd, bwd = lru_ops.lru_scan.launches, lru_ops.lru_scan_bwd.launches
    h, _ = lru_ops.lru_scan(a, x, h0)
    h.backward(dh)
    assert (lru_ops.lru_scan.launches, lru_ops.lru_scan_bwd.launches) == (
        fwd + 1, bwd + 1)
    want = lru_ops.lru_scan_bwd(a.detach(), h.detach(), dh, None,
                                h0.detach())
    for g, w in zip((a.grad, x.grad, h0.grad), want):
        assert torch.equal(g, w)


# B3's backward against the plain backwards in fp64 (sequential and
# chunked) on the same rounded inputs: T at the 16-token chunks' edges,
# rwkv6's serve prompt and a long one, B = 1 and 3, the decay's clamp ends;
# gradients normalised by max(1, their largest magnitude) (the state's
# gradient grows with T where decays are near 1); fp32 at the forward's
# limit, bf16 dr, dk, dv one bf16 ulp over 4e-3 (rounded once; dlog_w, du
# and dS0 fp32 on both sides)
WKV_BWD_T = [1, wk_ops.CHUNK - 1, wk_ops.CHUNK, wk_ops.CHUNK + 1,
             2 * wk_ops.CHUNK + 1, 370, 3000]


def _check_wkv6_bwd(r, k, v, lw, u, S0, dS, seed):
    rng = np.random.default_rng(seed)
    do = torch.from_numpy(rng.normal(size=r.shape)).to(r.device, r.dtype)
    scratch = wk_ops.wkv6_forward(r, k, v, lw, u, S0)[2]
    before = wk_ops.wkv6_bwd.launches
    got = wk_ops.wkv6_bwd(r, k, v, lw, u, do, S0, dS, scratch=scratch)
    torch.cuda.synchronize()
    assert wk_ops.wkv6_bwd.launches == before + 1
    assert [g.dtype for g in got[:3]] == [r.dtype] * 3
    assert got[3].dtype == got[4].dtype == torch.float32
    args = [x.double() for x in (r, k, v, lw, u, do)] + [
        None if x is None else x.double() for x in (S0, dS)]
    for want in (wk_ref.wkv6_backward(*args),
                 wk_ref.wkv6_backward_chunked(*args, chunk=wk_ops.CHUNK)):
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
                continue
            tol = WKV_TOL[r.dtype] if i < 3 else WKV_TOL[torch.float32]
            scale = max(1.0, float(w.abs().max()))
            torch.testing.assert_close(g.double() / scale, w / scale, **tol)
    again = wk_ops.wkv6_bwd(r, k, v, lw, u, do, S0, dS, scratch=scratch)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("t", WKV_BWD_T)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_backward_on_card(cuda_device, t, b, dtype, with_s0):
    r, k, v, lw, u, S0 = _wkv_on(cuda_device, b, 4, t, 64, dtype, with_s0,
                                 "uniform", t + b, layout="bthn")
    dS = None
    if with_s0:
        rng = np.random.default_rng(t)
        dS = torch.from_numpy(0.3 * rng.normal(size=S0.shape)).to(
            cuda_device, torch.float32)
    _check_wkv6_bwd(r, k, v, lw, u, S0, dS, t)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [wk_ops.CHUNK + 1, 370, 3000])
@pytest.mark.parametrize("fill", ["min", "max"])
def test_wkv6_backward_decay_extremes_on_card(cuda_device, t, fill):
    _check_wkv6_bwd(*_wkv_on(cuda_device, 1, 4, t, 64, torch.float32, False,
                             fill, t), None, t)


@pytest.mark.cuda
def test_wkv6_backward_at_the_train_shape(cuda_device):
    """rwkv6-3b's training shape, (4, 40, 2048, 64) bf16, as the model
    passes it: views of (B, T, H, N) projections; the gradients come back
    as views of contiguous (B, T, H, N) buffers."""
    r, k, v, lw, u, _ = _wkv_on(cuda_device, 4, 40, 2048, 64,
                                torch.bfloat16, False, "uniform", 1,
                                layout="bthn")
    do = _do_like(r, 2)
    o, S, scratch = wk_ops.wkv6_forward(r, k, v, lw, u)
    got = wk_ops.wkv6_bwd(r, k, v, lw, u, do, scratch=scratch)
    for g in got[:4]:
        assert g.transpose(1, 2).is_contiguous()
    want = wk_ref.wkv6_backward_chunked(
        *(x.double() for x in (r, k, v, lw, u, do)), chunk=wk_ops.CHUNK)
    for i, (g, w) in enumerate(zip(got[:5], want[:5])):
        tol = WKV_TOL[r.dtype] if i < 3 else WKV_TOL[torch.float32]
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.double() / scale, w / scale, **tol)


@pytest.mark.cuda
def test_wkv6_backward_repeats_its_bits_at_the_train_shape(cuda_device):
    """Two calls at rwkv6-3b's training shape, (4, 40, 2048, 64) bf16 with
    an entering state and a final-state gradient, give the same bits: no
    atomics, one order for every sum."""
    r, k, v, lw, u, S0 = _wkv_on(cuda_device, 4, 40, 2048, 64,
                                 torch.bfloat16, True, "uniform", 7,
                                 layout="bthn")
    dS = torch.from_numpy(0.3 * np.random.default_rng(8).normal(
        size=S0.shape)).to(cuda_device, torch.float32)
    do = _do_like(r, 9)
    scratch = wk_ops.wkv6_forward(r, k, v, lw, u, S0)[2]
    first = wk_ops.wkv6_bwd(r, k, v, lw, u, do, S0, dS, scratch=scratch)
    second = wk_ops.wkv6_bwd(r, k, v, lw, u, do, S0, dS, scratch=scratch)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_wkv6_autograd_launches_both_kernels(cuda_device):
    r, k, v, lw, u, S0 = _wkv_on(cuda_device, 2, 4, 77, 64, torch.bfloat16,
                                 True, "uniform", 3, layout="bthn")
    leaves = [x.detach().requires_grad_() for x in (r, k, v, lw, u, S0)]
    do = _do_like(r, 4)
    fwd, bwd = wk_ops.wkv6.launches, wk_ops.wkv6_bwd.launches
    o, _ = wk_ops.wkv6(*leaves)
    o.backward(do)
    assert (wk_ops.wkv6.launches, wk_ops.wkv6_bwd.launches) == (fwd + 1,
                                                                bwd + 1)
    _, S, scratch = wk_ops.wkv6_forward(r, k, v, lw, u, S0)
    want = wk_ops.wkv6_bwd(r, k, v, lw, u, do, S0, scratch=scratch)
    for g, w in zip((x.grad for x in leaves), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="head size"):
        x = _wkv_on(cuda_device, 1, 2, 20, 128, torch.float32, False,
                    "uniform", 5)
        wk_ops.wkv6_bwd(*x[:5], _do_like(x[0], 6),
                        scratch=wk_ops.wkv6_forward(*x[:5])[2])


# ---------------------------------------------------------------------------
# the cross-pod cluster and the cost capture on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compression_on_card_is_bit_identical_to_cpu(cuda_device, dtype):
    """int8 compression with error feedback: the card's quantized values,
    scales and residuals have the CPU's bits (each op is elementwise or an
    exact max)."""
    from repro_torch.optim import compress_tree_with_feedback, decompress_tree
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(257, 129)).astype(
        np.float32) * 1e-3).to(dtype),
        "b": {"c": torch.zeros(7, dtype=dtype),
              "d": torch.from_numpy(np.array(
                  [127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)).to(dtype)}}
    res = {"a": torch.from_numpy(rng.normal(size=(257, 129)).astype(
        np.float32) * 1e-5), "b": {"c": torch.zeros(7),
                                    "d": torch.zeros(6)}}
    from repro_torch.tree import flatten, tree_map
    on = lambda t: tree_map(lambda x: x.to(cuda_device), t)  # noqa: E731
    cpu = compress_tree_with_feedback(tree, res)
    card = compress_tree_with_feedback(on(tree), on(res))
    for c_tree, g_tree in zip(cpu, card):
        for (name, c), (_, g) in zip(flatten(c_tree), flatten(g_tree)):
            assert g.is_cuda and torch.equal(g.cpu(), c), name
    assert torch.equal(decompress_tree(*card[:2])["a"].cpu(),
                       decompress_tree(*cpu[:2])["a"])


@pytest.mark.cuda
def test_tree_digest_of_a_card_tree_equals_the_cpu_one(cuda_device):
    from repro_torch.ft import tree_digest
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = _card_train_cfg()
    params = _card_train_params(cfg, "cpu")
    for cast in (None, torch.bfloat16):
        tree = params if cast is None else lm.cast_params(
            params, dataclasses.replace(cfg, compute_dtype="bfloat16"))
        card = tree_map(lambda x: x.to(cuda_device), tree)
        assert tree_digest(card) == tree_digest(tree)


@pytest.mark.cuda
def test_tiny_cluster_under_chaos_is_bit_identical_to_fault_free(
        cuda_device, tmp_path):
    """The tiny cluster (head dim 64, bf16 compute, deterministic kernels)
    under a partition of pod 2 and a disk-full strike: every pod ends
    bit-identical to a fault-free cluster, through the fast path and both
    flash kernels."""
    from repro_torch.chaos import (DISK_FULL, NET_PARTITION, ChaosEngine,
                                   FaultEvent, FaultTrace)
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.ft import CheckpointStore, PodTrainingCluster, tree_digest
    cfg = dataclasses.replace(_card_train_cfg(), compute_dtype="bfloat16")
    trace = FaultTrace(events=[
        FaultEvent(step=2, kind=NET_PARTITION, targets=(2,), duration=3),
        FaultEvent(step=6, kind=DISK_FULL)])
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for name, chaos in (("chaos", ChaosEngine(trace)), ("clean", None)):
            fwd = fa_ops.flash_attention.launches
            bwd = fa_ops.flash_attention_bwd.launches
            cluster = PodTrainingCluster(
                cfg=cfg, params=_card_train_params(cfg, cuda_device),
                pipeline=SyntheticTokenPipeline(DataConfig(2, 96), cfg),
                store=CheckpointStore(str(tmp_path / name)), n_pods=3,
                q_chunk=96, xent_chunk=32, ckpt_every=4, chaos=chaos)
            rep = cluster.run(8)
            runs[name] = (cluster, rep,
                          fa_ops.flash_attention.launches - fwd,
                          fa_ops.flash_attention_bwd.launches - bwd)
    finally:
        torch.use_deterministic_algorithms(False)
    cluster, rep, fwd, bwd = runs["chaos"]
    assert rep.steps_completed == 8 and rep.partitions == 1
    assert rep.catchups == 1 and rep.enospc_retries >= 1
    assert rep.split_brain_divergences == 0 and rep.index_violations == 0
    assert fwd > 0 and bwd > 0
    want = tree_digest(runs["clean"][0].params[0])
    assert all(tree_digest(cluster.params[p]) == want for p in range(3))
    assert runs["clean"][1].losses == rep.losses


@pytest.mark.cuda
def test_capture_cost_on_card_counts_the_kernels(cuda_device):
    """``capture_cost`` of the tiny forward on the card: the flash kernel's
    own report is in the count, and the total is within
    ``tests/test_analysis.py``'s bound (rel 0.35) of ``cell_flops``."""
    from repro_torch.analysis import flops as F
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import Shape
    from repro_torch.models import lm
    from repro_torch.obs import profile_jit
    cfg = dataclasses.replace(
        get_config("olmo_1b", tiny=True), n_layers=3, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=2048, head_dim=64,
        compute_dtype="float32", remat=False)
    b, s = 2, 256
    params = _card_train_params(cfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=cuda_device)

    def last_logits(p, t):
        x = p["embed"][t.long()]
        pos = torch.arange(s, device=t.device)[None].expand(b, -1)
        h, _ = lm.backbone(p, cfg, x, pos)
        return h[:, -1] @ lm.output_weights(p, cfg, torch.float32)

    prof = profile_jit(last_logits, name="fwd")
    with torch.no_grad():
        cost = prof.capture_cost(params, tokens)
    assert cost["kernels"]["flash_attention"]["launches"] == cfg.n_layers
    assert cost["kernels"]["flash_attention"]["flops"] > 0
    analytic = F.cell_flops(cfg, Shape("prefill_test", "prefill", s, b)).flops
    assert analytic == pytest.approx(cost["flops"], rel=0.35)


@pytest.fixture
def cuda_mesh(cuda_device):
    """A one-rank ("data", "model") mesh on the card (its world-size-1 NCCL
    group ended after the test)."""
    from repro_torch.launch.mesh import destroy_group, make_debug_mesh
    mesh = make_debug_mesh(device=cuda_device)
    yield mesh
    destroy_group()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_flash_on_a_mesh_is_bit_equal_to_the_direct_call(cuda_mesh, causal,
                                                         window):
    """B2 forward and backward through the model's ``local_map`` call site
    on a 1x1 CUDA mesh give the direct kernel calls' bits, and launch."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import layers
    b, h, kv, s, d = 2, 8, 4, 256, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    # (B, S, H, D) projections seen as (B, H, S, D) views, as the model
    # passes them
    q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (h, kv, kv))
    do = torch.randn((b, h, s, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa_ops.attention(*leaves, causal=causal, window=window)
    want = (out, *torch.autograd.grad(out, leaves, do))
    dts = [DTensor.from_local(t.detach(), cuda_mesh, [Shard(0), Shard(1)])
           .requires_grad_() for t in (q, k, v)]
    f0, b0 = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    with use_rules(cuda_mesh):
        out = layers._flash(*dts, causal=causal, window=window)
        got = (out, *torch.autograd.grad(
            out, dts, DTensor.from_local(do, cuda_mesh, out.placements)))
    assert fa_ops.flash_attention.launches > f0
    assert fa_ops.flash_attention_bwd.launches > b0
    for x, y in zip(got, want):
        assert torch.equal(x.to_local(), y)


@pytest.mark.cuda
def test_lru_scan_on_a_mesh_is_bit_equal_to_the_direct_call(cuda_mesh):
    """B4 forward and backward through the RG-LRU call site on a 1x1 CUDA
    mesh give the direct calls' bits."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import rglru
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand((2, 300, 256), generator=g, device="cuda")
    x = torch.randn((2, 300, 256), generator=g, device="cuda")
    dh = torch.randn((2, 300, 256), generator=g, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (a, x)]
    h, _ = lru_ops.lru_scan(*leaves)
    want = (h, *torch.autograd.grad(h, leaves, dh))
    dts = [DTensor.from_local(t.clone(), cuda_mesh, [Shard(0), Shard(2)])
           .requires_grad_() for t in (a, x)]
    f0, b0 = lru_ops.lru_scan.launches, lru_ops.lru_scan_bwd.launches
    with use_rules(cuda_mesh):
        h, _ = rglru._scan(*dts)
        got = (h, *torch.autograd.grad(
            h, dts, DTensor.from_local(dh, cuda_mesh, h.placements)))
    assert lru_ops.lru_scan.launches > f0
    assert lru_ops.lru_scan_bwd.launches > b0
    for x_, y in zip(got, want):
        assert torch.equal(x_.to_local(), y)
