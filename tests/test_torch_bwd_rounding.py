"""The bf16 flash-attention backward's rounding, on the CPU.

The tensor-core backward (``csrc/flash_attention_bwd.cu``) rounds P and dS
to bf16 before the products that take them, where the fp32 plain backward
keeps them in fp32.  ``ref.attention_backward_rounded`` is that arithmetic
(P and dS in bf16, every sum in fp32, each gradient rounded to bf16 once):
here it is held, on numpy-seeded bf16 inputs, against the fp32 plain
backward within the bf16 limit the card checks hold the kernel to
(``FA_BWD_TOL`` of ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
The card runs the kernel itself against the same fp32 reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

# bf16: atol 4e-3, rtol 1e-2 of each gradient over max(1, |grad|max), the
# card checks' limit, unchanged
FA_BWD_TOL = dict(atol=4e-3, rtol=1e-2)
# (B, H, KV, S, D, causal, window): olmo-1b's head dim and sequence at two
# heads, D = 64, a GQA group of 4, window 37, bidirectional (ragged S)
CASES = [(1, 2, 2, 2048, 128, True, 0), (1, 2, 2, 2048, 64, True, 0),
         (1, 4, 1, 300, 128, True, 0), (1, 4, 2, 300, 64, True, 37),
         (2, 4, 2, 129, 128, False, 0), (1, 4, 1, 65, 64, False, 0)]


def _inputs(b, h, kv, s, d, seed):
    """q, k, v, dO in bf16, as the model hands them to the kernel: (B, H,
    S, D) views of (B, S, H, D) tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to(torch.bfloat16).transpose(1, 2)
        for n in (h, kv, kv, h)]


def _grads(b, h, kv, s, d, causal, window):
    """(rounded, fp32 plain) gradients on the same inputs; o is the bf16
    output and lse the fp32 row log-sum-exp, as the forward kernel gives
    them."""
    q, k, v, do = _inputs(b, h, kv, s, d, s + d + window)
    kw = dict(causal=causal, window=window)
    o = ref.attention(q, k, v, **kw)
    lse = ref.attention_lse(q, k, v, **kw)
    got = ref.attention_backward_rounded(q, k, v, o, lse, do, **kw)
    want = ref.attention_backward(q.float(), k.float(), v.float(), o.float(),
                                  lse, do.float(), **kw)
    return got, want


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", CASES)
def test_rounded_backward_holds_the_bf16_limit(b, h, kv, s, d, causal,
                                               window):
    got, want = _grads(b, h, kv, s, d, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.float() / scale, w / scale,
                                   **FA_BWD_TOL)


def test_rounding_reaches_the_products():
    """The emulation rounds P and dS and not only the gradients: its result
    differs from the plain backward rounded once to bf16."""
    q, k, v, do = _inputs(1, 2, 2, 256, 64, 3)
    o = ref.attention(q, k, v)
    lse = ref.attention_lse(q, k, v)
    rounded = ref.attention_backward_rounded(q, k, v, o, lse, do)
    once = ref.attention_backward(q, k, v, o, lse, do)
    for a, b in zip(rounded, once):
        assert a.dtype == b.dtype == torch.bfloat16
    assert not all(torch.equal(a, b) for a, b in zip(rounded, once))
