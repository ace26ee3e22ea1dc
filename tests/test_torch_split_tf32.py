"""The fp32 flash-attention kernels' split-TF32 arithmetic, on the CPU.

The fp32 kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
take every product on the tensor cores as a split TF32 product: each
operand x split into ``hi = tf32(x)`` (rounded as ``cvt.rna.tf32.f32``
rounds) and ``lo = x - hi`` (read by the tensor cores truncated to TF32),
three TF32 products ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` summed in
fp32.  ``ref.attention_split_tf32`` and
``ref.attention_backward_split_tf32`` are that arithmetic; here they are
held, on numpy-seeded fp32 inputs, against the port's fp32 plain versions
and the JAX package's reference (its ``attention``, and ``jax.vjp`` of it,
or of the model's ``_sdpa`` under the local mask where there is a window)
at the unchanged fp32 limit, the gradients over max(1, |grad|max) as the
card checks normalise them.  One TF32 pass (``hi`` alone) breaks that
limit where the split holds it.  The card runs the kernels against the
same plain versions (``tests/test_torch_cuda.py``).
"""
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

# the fp32 limit of the JAX tests and the card checks, unchanged
FA_TOL = dict(atol=2e-4, rtol=2e-4)
# (B, H, KV, Sq, Sk, D, causal, window): the cases of
# tests/test_torch_bwd_rounding.py (olmo-1b's head dim and sequence at two
# heads, D = 64, a GQA group of 4, window 37, ragged bidirectional; D = 256
# as recurrentgemma-2b has it, 10 query heads on one KV head, under windows
# 37 and 200, and ragged bidirectional), then whisper-small's cross
# attention of 77 decoder rows to its 1500 frames (Sq != Sk)
CASES = [(1, 2, 2, 2048, 2048, 128, True, 0),
         (1, 2, 2, 2048, 2048, 64, True, 0),
         (1, 4, 1, 300, 300, 128, True, 0), (1, 4, 2, 300, 300, 64, True, 37),
         (2, 4, 2, 129, 129, 128, False, 0), (1, 4, 1, 65, 65, 64, False, 0),
         (1, 10, 1, 300, 300, 256, True, 37),
         (1, 10, 1, 700, 700, 256, True, 200),
         (2, 4, 2, 129, 129, 256, False, 0),
         (1, 12, 12, 77, 1500, 64, False, 0)]


def _inputs(b, h, kv, sq, sk, d, seed):
    """q, k, v, dO in fp32 as numpy arrays (B, H, S, D), and as the model
    hands them to the kernels: (B, H, S, D) views of (B, S, H, D)
    tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n, s in ((h, sq), (kv, sk), (kv, sk), (h, sq))]
    return ([a.transpose(0, 2, 1, 3) for a in arrs],
            [torch.from_numpy(a).transpose(1, 2) for a in arrs])


def _jax_attention(causal, window, sq, sk):
    """JAX's reference as a function of (q, k, v), (B, H, S, D): the
    kernel package's oracle, or the model's ``_sdpa`` with the local mask
    ``attention_forward(mode="local")`` builds where there is a window."""
    if not window:
        return lambda q, k, v: jfa_ref.attention(q, k, v, causal=causal)
    kpos = jnp.arange(sk)
    mask = lambda qp: ((qp[:, None] >= kpos[None, :])  # noqa: E731
                       & (qp[:, None] - kpos[None, :] < window))
    return lambda q, k, v: jlayers._sdpa(
        *(x.transpose(0, 2, 1, 3) for x in (q, k, v)), mask).transpose(
            0, 2, 1, 3)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g / scale, w / scale, **FA_TOL)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", CASES)
def test_split_forward_holds_the_fp32_limit(b, h, kv, sq, sk, d, causal,
                                            window):
    (nq, nk, nv, _), (q, k, v, _) = _inputs(b, h, kv, sq, sk, d,
                                            sq + sk + d + window)
    kw = dict(causal=causal, window=window)
    got = ref.attention_split_tf32(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    torch.testing.assert_close(got, ref.attention(q, k, v, **kw), **FA_TOL)
    want = _jax_attention(causal, window, sq, sk)(nq, nk, nv)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **FA_TOL)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", CASES)
def test_split_backward_holds_the_fp32_limit(b, h, kv, sq, sk, d, causal,
                                             window):
    (nq, nk, nv, ndo), (q, k, v, do) = _inputs(b, h, kv, sq, sk, d,
                                               sq + sk + d + window + 1)
    kw = dict(causal=causal, window=window)
    o = ref.attention(q, k, v, **kw)
    lse = ref.attention_lse(q, k, v, **kw)
    got = ref.attention_backward_split_tf32(q, k, v, o, lse, do, **kw)
    _assert_grads_close(got, ref.attention_backward(q, k, v, o, lse, do,
                                                    **kw))
    _, vjp = jax.vjp(_jax_attention(causal, window, sq, sk), nq, nk, nv)
    _assert_grads_close(got, vjp(jnp.asarray(ndo)))


def test_one_tf32_pass_breaks_the_limit_the_split_holds():
    """olmo-1b's head dim at 2048 causal positions: a single TF32 pass a
    product (``hi`` alone, ~2^-11 of each operand lost) leaves the forward
    and the gradients past the fp32 limit, the split within it."""
    _, (q, k, v, do) = _inputs(1, 2, 2, 2048, 2048, 128, 11)
    o = ref.attention(q, k, v)
    lse = ref.attention_lse(q, k, v)
    want_o = o
    want = ref.attention_backward(q, k, v, o, lse, do)
    for terms, holds in ((3, True), (1, False)):
        got_o = ref.attention_split_tf32(q, k, v, terms=terms)
        got = ref.attention_backward_split_tf32(q, k, v, o, lse, do,
                                                terms=terms)
        fwd = torch.allclose(got_o, want_o, **FA_TOL)
        bwd = all(torch.allclose(g / max(1.0, float(w.abs().max())),
                                 w / max(1.0, float(w.abs().max())),
                                 **FA_TOL) for g, w in zip(got, want))
        assert (fwd and bwd) == holds, (terms, fwd, bwd)
        if not holds:
            assert not fwd and not bwd


def _rna_bits(bits: int) -> int:
    """``cvt.rna.tf32.f32`` of the fp32 with these bits, by its definition,
    in double arithmetic: x to the nearest multiple of TF32's spacing at its
    binade (2^(e - 10); the subnormals on the smallest normal binade's
    spacing, 2^-136), ties away from zero, past the largest fp32 value inf;
    inf as it is.  A NaN keeps its bits but the low 13, as the card does
    (0x7F800001 comes back as inf, 0x7FFFFFFF as 0x7FFFE000): NaNs are
    handled on their bits, never through a Python float, which may quiet
    them."""
    if bits & 0x7F800000 == 0x7F800000 and bits & 0x007FFFFF:
        return bits & ~0x1FFF
    x = struct.unpack("<f", struct.pack("<I", bits))[0]
    if math.isinf(x) or x == 0.0:
        return bits
    e = max(math.frexp(abs(x))[1] - 1, -126)
    ulp = 2.0 ** (e - 10)
    y = math.copysign(math.floor(abs(x) / ulp + 0.5) * ulp, x)
    if abs(y) >= 2.0 ** 128:
        y = math.copysign(math.inf, x)
    return struct.unpack("<I", struct.pack("<f", y))[0]


def _round_bits(bits):
    """``ref.tf32_round`` on fp32 values given by their bits (uint32), as
    uint32 bits: in and out through int32 views, never Python floats."""
    x = torch.from_numpy(np.asarray(bits, np.uint32).view(np.int32).copy())
    out = ref.tf32_round(x.view(torch.float32)).view(torch.int32).numpy()
    return out.view(np.uint32)


# (name, fp32 bits): zeros, ones, a value off the grid, ties (to an even and
# an odd neighbour, both away from zero) and just under a tie, negatives,
# the smallest and largest subnormals, a subnormal tie, the smallest
# normal, the largest value that stays finite and the largest fp32 value
# (rounds to inf), infinities and NaNs (quiet, one whose payload lies only
# in the cleared bits and so comes back as inf, the largest NaN)
EDGES = [("zero", 0x00000000), ("minus_zero", 0x80000000),
         ("one", 0x3F800000), ("minus_one", 0xBF800000),
         ("pi", 0x40490FDB), ("minus_pi", 0xC0490FDB),
         ("tie_up_from_even", 0x3F801000), ("tie_up_from_odd", 0x3F803000),
         ("minus_tie", 0xBF801000), ("under_tie", 0x3F800FFF),
         ("over_tie", 0x3F801001),
         ("smallest_subnormal", 0x00000001),
         ("subnormal_tie", 0x00001000), ("subnormal_under_tie", 0x00000FFF),
         ("largest_subnormal", 0x007FFFFF),
         ("minus_subnormal", 0x80123456),
         ("smallest_normal", 0x00800000),
         ("largest_kept_finite", 0x7F7FEFFF),
         ("largest_finite", 0x7F7FFFFF), ("minus_largest", 0xFF7FFFFF),
         ("inf", 0x7F800000), ("minus_inf", 0xFF800000),
         ("nan", 0x7FC00000), ("nan_low_payload", 0x7F800001),
         ("nan_all_ones", 0x7FFFFFFF), ("minus_nan", 0xFFC00000)]


@pytest.mark.parametrize("name,bits", EDGES, ids=[e[0] for e in EDGES])
def test_tf32_round_matches_cvt_rna_on_edge_values(name, bits):
    got = int(_round_bits([bits])[0])
    assert got == _rna_bits(bits), (hex(bits), hex(got))
    # a TF32 value (low 13 bits clear) that rounds to itself
    assert got & 0x1FFF == 0 and int(_round_bits([got])[0]) == got


def test_tf32_round_matches_cvt_rna_on_random_bits():
    """Every class of fp32 bit pattern at once: 20000 seeded draws over
    the whole 32-bit range, against the definition."""
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 20000,
                                             dtype=np.uint64)
    got = _round_bits(bits.astype(np.uint32))
    for b, g in zip(bits.tolist(), got.tolist()):
        assert g == _rna_bits(b), (hex(b), hex(g))


def test_split_parts_are_tf32_and_exact_to_two_passes():
    """hi and lo as the tensor cores read them are TF32 values, hi + lo
    holds x to 2^-21 of |x| (what reading lo truncated leaves), and hi alone
    only to 2^-11."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=4096).astype(np.float32))
    hi = ref.tf32_round(x)
    lo = ref.tf32_truncate(x - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -21
    assert ((hi.double() - x.double()).abs()
            / x.double().abs()).max() > 2.0 ** -13
