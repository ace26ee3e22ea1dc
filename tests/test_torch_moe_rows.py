"""The MoE layer's dispatch and combine (``kernels/moe_rows``) on the CPU.

The plain version (``ref.py``) against the layer's gathers as they were
written before the kernels (frozen below) bit for bit, forward and every
gradient, and against a loop over the pairs; the entry points' refusal of a
CPU tensor and their shape-only path; no CPU call counts a launch.  The
kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _cost  # noqa: E402
from repro_torch.kernels.moe_rows import ops, ref  # noqa: E402

ENTRIES = (ops.dispatch_fwd, ops.combine_fwd, ops.combine_bwd,
           ops.dispatch_bwd)


# -- the MoE layer's gathers as models/layers.py had them -------------------

def _old_pick(x, idx):
    n = x.shape[0]
    return x[idx.clamp(max=n - 1)].masked_fill_((idx == n)[..., None], 0)


class _OldRoute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _old_pick(x, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        dx = _old_pick(grad, inv).sum(1, dtype=torch.float32)
        return dx.to(grad.dtype), None, None


def _old_dispatch(x, slot, token_at):
    return _OldRoute.apply(x, token_at, slot)


def _old_combine(ye, gate_vals, slot, pair_at):
    g_count, g, k = gate_vals.shape
    d = ye.shape[-1]
    got = _OldRoute.apply(ye, slot.reshape(-1), pair_at[:, None])
    got = got.to(torch.float32).reshape(g_count, g, k, d)
    weight = gate_vals.sum(-1, keepdim=True)
    return (got * weight[..., None]).sum(2).to(ye.dtype)


# -- routes -----------------------------------------------------------------

def _routes(g_count, g, k, e, cf, seed):
    """Index maps as ``layers._moe`` builds them, by a loop: each token's k
    distinct experts, slots in token-major order within a group, pairs past
    the capacity dropped.  Returns (slot, token_at, pair_at, gate_vals)."""
    rng = np.random.default_rng(seed)
    cap = max(int(math.ceil(g * k / e * cf)), 4)
    n_tok, n_slot = g_count * g, e * g_count * cap
    slot = np.full((n_tok, k), n_slot, dtype=np.int64)
    token_at = np.full(n_slot, n_tok, dtype=np.int64)
    pair_at = np.full(n_slot, n_tok * k, dtype=np.int64)
    for gi in range(g_count):
        fill = np.zeros(e, dtype=np.int64)
        for t in range(g):
            tok = gi * g + t
            for j, ex in enumerate(rng.choice(e, k, replace=False)):
                if fill[ex] < cap:
                    s = (ex * g_count + gi) * cap + fill[ex]
                    fill[ex] += 1
                    slot[tok, j], token_at[s], pair_at[s] = s, tok, tok * k + j
    gates = rng.uniform(0.05, 1.0, (g_count, g, k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    return (torch.from_numpy(slot), torch.from_numpy(token_at),
            torch.from_numpy(pair_at), torch.from_numpy(gates))


# (groups, tokens a group, k, experts, capacity factor, d): granite-moe's
# top 8 of 32, phi3.5-moe's top 2 of 16, capacity drops, a decode group
# of 3 rows (capacity 4), d off the 16-byte grid in bf16
CASES = {"top8_of_32": (2, 40, 8, 32, 1.25, 64),
         "top2_of_16": (3, 24, 2, 16, 1.25, 96),
         "drops": (2, 24, 2, 4, 0.3, 64),
         "decode": (1, 3, 2, 4, 1.25, 64),
         "odd_width": (1, 17, 3, 5, 1.0, 36)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype, seed=0):
    g_count, g, k, e, cf, d = CASES[case]
    slot, token_at, pair_at, gates = _routes(g_count, g, k, e, cf, seed)
    gen = torch.Generator().manual_seed(seed)
    n_tok, n_slot = slot.shape[0], token_at.shape[0]
    x = torch.randn((n_tok, d), generator=gen).to(dtype)
    ye = torch.randn((n_slot, d), generator=gen).to(dtype)
    dxe = torch.randn((n_slot, d), generator=gen).to(dtype)
    dout = torch.randn((g_count, g, d), generator=gen).to(dtype)
    return slot, token_at, pair_at, gates, x, ye, dxe, dout


def _run(dispatch, combine, case, dtype):
    """Forward and gradients of both directions, as the layer calls them."""
    slot, token_at, pair_at, gates, x, ye, dxe, dout = _inputs(case, dtype)
    x, ye, gates = (t.clone().requires_grad_() for t in (x, ye, gates))
    xe = dispatch(x, slot, token_at)
    out = combine(ye, gates, slot, token_at, pair_at)
    torch.autograd.backward([xe, out], [dxe, dout])
    return {"xe": xe, "out": out, "dx": x.grad, "dye": ye.grad,
            "dgates": gates.grad}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_the_layers_gathers_bit_for_bit(case, dtype):
    """ops on the CPU (the plain version) give the frozen gathers' outputs
    and gradients to the bit, sentinel rows and dropped pairs included."""
    dt = DTYPES[dtype]
    got = _run(ops.dispatch, ops.combine, case, dt)
    want = _run(_old_dispatch,
                lambda ye, gv, slot, token_at, pair_at:
                _old_combine(ye, gv, slot, pair_at), case, dt)
    slot = _inputs(case, dt)[0]
    if case == "drops":
        assert (slot == got["xe"].shape[0]).any()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_against_a_loop_over_pairs(case):
    """The functions the kernels compute, by a loop in fp64 over the
    pairs, against the plain version in fp32 (its sums' rounding)."""
    slot, token_at, pair_at, gates, x, ye, dxe, dout = _inputs(
        case, torch.float32)
    got = _run(ops.dispatch, ops.combine, case, torch.float32)
    n_tok, k = slot.shape
    n_slot, d = ye.shape
    w = gates.reshape(n_tok, k).double().sum(-1)
    g = dout.reshape(n_tok, d).double()
    xe = torch.zeros((n_slot, d), dtype=torch.float64)
    out = torch.zeros((n_tok, d), dtype=torch.float64)
    dx = torch.zeros((n_tok, d), dtype=torch.float64)
    dye = torch.zeros((n_slot, d), dtype=torch.float64)
    dw = torch.zeros(n_tok, dtype=torch.float64)
    for t in range(n_tok):
        for j in range(k):
            s = int(slot[t, j])
            if s == n_slot:
                continue
            assert int(token_at[s]) == t and int(pair_at[s]) == t * k + j
            xe[s] = x[t].double()
            out[t] += ye[s].double() * w[t]
            dx[t] += dxe[s].double()
            dye[s] = g[t] * w[t]
            dw[t] += (g[t] * ye[s].double()).sum()
    assert torch.equal(got["xe"].double(), xe)
    tol = dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got["out"].reshape(n_tok, d).double(), out,
                               **tol)
    torch.testing.assert_close(got["dx"].double(), dx, **tol)
    torch.testing.assert_close(got["dye"].double(), dye, **tol)
    torch.testing.assert_close(got["dgates"].reshape(n_tok, k).double(),
                               dw[:, None].expand(n_tok, k), **tol)


@pytest.mark.parametrize("case", ["top8_of_32", "drops"])
def test_cpu_calls_count_no_launch(case):
    """The CPU takes the plain version: every launch counter stays where
    it was (at 0 where no card ran a kernel in this process)."""
    before = [f.launches for f in ENTRIES]
    for dtype in DTYPES.values():
        _run(ops.dispatch, ops.combine, case, dtype)
    assert [f.launches for f in ENTRIES] == before
    if not torch.cuda.is_available():
        assert before == [0, 0, 0, 0]


def test_entry_points_refuse_a_cpu_tensor():
    """No fallback: the kernels' entry points raise for a CPU tensor."""
    slot, token_at, pair_at, gates, x, ye, dxe, dout = _inputs(
        "drops", torch.float32)
    w = gates.reshape(-1, slot.shape[1]).sum(-1)
    g = dout.reshape(slot.shape[0], -1)
    calls = [lambda: ops.dispatch_fwd(x, token_at),
             lambda: ops.combine_fwd(ye, slot, w),
             lambda: ops.combine_bwd(g, ye, w, slot, token_at),
             lambda: ops.dispatch_bwd(dxe, slot)]
    for call in calls:
        with pytest.raises(ValueError, match="no moe_rows kernel"):
            call()


def test_layer_calls_on_fake_tensors_take_the_kernels_shapes():
    """The dry run's fake tensors go the kernels' way, not the plain
    version's: dispatch and combine, forward and backward, report the four
    kernel launches and launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = [f.launches for f in ENTRIES]
    with FakeTensorMode(allow_non_fake_inputs=True):
        slot, token_at, pair_at, gates, x, ye, dxe, dout = _inputs(
            "drops", torch.bfloat16)
        with _cost.capture() as sink:
            got = _run(ops.dispatch, ops.combine, "drops", torch.bfloat16)
    assert [f.launches for f in ENTRIES] == before
    assert {k: v["launches"] for k, v in sink.items()} == {
        "moe_gather_rows": 1, "moe_sum_rows": 2, "moe_combine_bwd": 1}
    assert tuple(got["out"].shape) == tuple(dout.shape)
    assert tuple(got["dgates"].shape) == tuple(gates.shape)


def test_shape_only_calls_report_their_work():
    """Fake tensors (the dry run's): each entry point returns its outputs'
    shapes and dtypes and reports one launch's bytes, launching nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_tok, k, n_slot, d = 48, 8, 640, 64
    before = [f.launches for f in ENTRIES]
    with FakeTensorMode():
        x = torch.empty((n_tok, d), dtype=torch.bfloat16)
        ye = torch.empty((n_slot, d), dtype=torch.bfloat16)
        slot = torch.empty((n_tok, k), dtype=torch.int64)
        token_at = torch.empty((n_slot,), dtype=torch.int64)
        w = torch.empty((n_tok,), dtype=torch.float32)
        with _cost.capture() as sink:
            xe = ops.dispatch_fwd(x, token_at)
            out = ops.combine_fwd(ye, slot, w)
            d_ye, d_w = ops.combine_bwd(x, ye, w, slot, token_at)
            dx = ops.dispatch_bwd(ye, slot)
    assert [f.launches for f in ENTRIES] == before
    assert tuple(xe.shape) == (n_slot, d) and xe.dtype == torch.bfloat16
    assert tuple(out.shape) == tuple(dx.shape) == (n_tok, d)
    assert tuple(d_ye.shape) == (n_slot, d) and d_ye.dtype == torch.bfloat16
    assert tuple(d_w.shape) == (n_tok,) and d_w.dtype == torch.float32
    row = 2 * d
    assert sink["moe_gather_rows"] == {
        "flops": 0.0, "launches": 1,
        "bytes": float((n_slot + n_tok) * row + 8 * n_slot)}
    assert sink["moe_sum_rows"]["launches"] == 2
    assert sink["moe_combine_bwd"]["bytes"] == float(
        (n_tok + n_tok * k + n_slot) * row + 8 * (n_tok * k + n_slot)
        + 8 * n_tok)
