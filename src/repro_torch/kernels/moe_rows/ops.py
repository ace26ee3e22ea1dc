"""Wrapper of the MoE layer's row kernels (``csrc/moe_rows.cu``).

:func:`dispatch` and :func:`combine` take the plain versions in ``ref.py``
for a CPU tensor; for a CUDA tensor they go through :class:`_Dispatch` and
:class:`_Combine`, whose forwards and backwards each launch one kernel, or
raise.  A fake tensor (the dry run's) takes that path too and gets the
kernels' output shapes.  The four entry points count their launches
(``.launches``) and report their work to ``_cost``:

* :func:`dispatch_fwd`: ``xe[s] = x[token_at[s]]``, a zero row for the
  sentinel ``n_tok`` (a copy);
* :func:`combine_fwd`: ``out[t] = sum_j fp32(ye[slot[t, j]]) * w[t]`` over
  the kept j, in order, rounded once;
* :func:`combine_bwd`: ``d_ye[s] = fp32(g[t]) * w[t]`` rounded once, ``t =
  token_at[s]`` (zeros for an empty slot), and ``d_w[t] = sum_{j, c} g[t, c]
  fp32(ye[slot[t, j], c])``;
* :func:`dispatch_bwd`: ``dx[t] = sum_j fp32(dxe[slot[t, j]])`` over the
  kept j, in order, rounded once.

Rows are fp32 or bf16, indices int64 (``slot`` (n_tok, k) with the sentinel
``n_slot`` for a dropped pair, ``token_at`` (n_slot,)), the weights fp32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _cost
from . import ref

__all__ = ["dispatch", "combine", "dispatch_fwd", "dispatch_bwd",
           "combine_fwd", "combine_bwd"]

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    lib = _build.load("moe_rows")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.moe_gather_rows_launch.argtypes = [ptr] * 4 + [i64, i64, i32, i32,
                                                       ptr]
    lib.moe_sum_rows_launch.argtypes = [ptr] * 4 + [i64, i32, i64, i32, i32,
                                                    ptr]
    lib.moe_combine_bwd_launch.argtypes = [ptr] * 7 + [i64, i32, i64, i32,
                                                       i32, ptr]
    for fn in (lib.moe_gather_rows_launch, lib.moe_sum_rows_launch,
               lib.moe_combine_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


def dispatch(x, slot, token_at):
    """x (n_tok, d) into the expert slots: (n_slot, d), row s ``x[token_at[s]]``
    or zeros for ``token_at[s] == n_tok``.  Its gradient sums each token's
    slots ``slot`` (n_tok, k) in fp32 in order of j and rounds once."""
    if x.device.type == "cpu" and not _cost.shape_only(x):
        return ref.dispatch(x, slot, token_at)
    return _Dispatch.apply(x, slot, token_at)


def combine(ye, gate_vals, slot, token_at, pair_at):
    """The slots' rows ye (n_slot, d) back to the tokens, each kept choice
    weighted by the sum of the token's gates ``gate_vals`` (..., k) fp32:
    shape ``gate_vals.shape[:-1] + (d,)`` in ye's dtype.  ``token_at`` and
    ``pair_at`` (n_slot,) give each slot's token and (token, choice) pair
    (``n_tok``, ``n_tok * k`` for an empty slot); the plain version takes
    ``pair_at``, the kernels ``token_at``."""
    if ye.device.type == "cpu" and not _cost.shape_only(ye):
        return ref.combine(ye, gate_vals, slot, pair_at)
    w = gate_vals.sum(-1)
    out = _Combine.apply(ye, w.reshape(-1), slot, token_at)
    return out.reshape(*w.shape, ye.shape[-1])


class _Dispatch(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, slot, token_at):
        ctx.save_for_backward(slot)
        return dispatch_fwd(x, token_at)

    @staticmethod
    def backward(ctx, dxe):
        (slot,) = ctx.saved_tensors
        return dispatch_bwd(dxe, slot), None, None


class _Combine(torch.autograd.Function):

    @staticmethod
    def forward(ctx, ye, w, slot, token_at):
        ctx.save_for_backward(ye, w, slot, token_at)
        return combine_fwd(ye, slot, w)

    @staticmethod
    def backward(ctx, g):
        ye, w, slot, token_at = ctx.saved_tensors
        d_ye, d_w = combine_bwd(g, ye, w, slot, token_at)
        return d_ye, d_w, None, None


def _check(rows, *index):
    if rows.device.type != "cuda":
        raise ValueError(f"no moe_rows kernel for {rows.device}")
    if rows.dtype not in _DTYPES:
        raise ValueError(f"moe_rows takes rows in {_DTYPES}, not "
                         f"{rows.dtype}")
    if rows.ndim != 2 or rows.shape[1] == 0:
        raise ValueError(f"rows must be (n, d) with d > 0, got "
                         f"{tuple(rows.shape)}")
    for i in index:
        if i.dtype != torch.int64 or i.device != rows.device:
            raise ValueError("moe_rows indices must be int64 on the rows' "
                             "device")


def _launch(fn, *args, device):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_rows kernel launch failed: CUDA error {err}")


def dispatch_fwd(x, token_at):
    """(n_slot, d) rows ``x[token_at]``, zeros for the sentinel ``len(x)``."""
    n_slot = token_at.shape[0]
    if _cost.shape_only(x):
        _report_gather(x, n_slot, weighted=False)
        return x.new_empty((n_slot, x.shape[1]))
    _check(x, token_at)
    x, token_at = x.contiguous(), token_at.contiguous()
    out = torch.empty((n_slot, x.shape[1]), dtype=x.dtype, device=x.device)
    _launch(_lib().moe_gather_rows_launch, x.data_ptr(), token_at.data_ptr(),
            None, out.data_ptr(), n_slot, x.shape[0], x.shape[1],
            int(x.dtype == torch.bfloat16), device=x.device)
    dispatch_fwd.launches += 1
    _report_gather(x, n_slot, weighted=False)
    return out


dispatch_fwd.launches = 0


def combine_fwd(ye, slot, w):
    """(n_tok, d): token t the fp32 sum over j of ``ye[slot[t, j]] * w[t]``
    (the sentinel ``len(ye)`` skipped), rounded to ye's dtype."""
    return _sum_rows(ye, slot, w, combine_fwd)


combine_fwd.launches = 0


def dispatch_bwd(dxe, slot):
    """(n_tok, d): token t the fp32 sum over j of ``dxe[slot[t, j]]`` (the
    sentinel ``len(dxe)`` skipped), rounded to dxe's dtype."""
    return _sum_rows(dxe, slot, None, dispatch_bwd)


dispatch_bwd.launches = 0


def _sum_rows(src, slot, w, entry):
    n_tok, k = slot.shape
    if _cost.shape_only(src):
        _report_sum(src, slot, w)
        return src.new_empty((n_tok, src.shape[1]))
    _check(src, slot)
    src, slot = src.contiguous(), slot.contiguous()
    if w is not None:
        w = w.to(torch.float32).contiguous()
    out = torch.empty((n_tok, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    _launch(_lib().moe_sum_rows_launch, src.data_ptr(), slot.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), n_tok, k,
            src.shape[0], src.shape[1], int(src.dtype == torch.bfloat16),
            device=src.device)
    entry.launches += 1
    _report_sum(src, slot, w)
    return out


def combine_bwd(g, ye, w, slot, token_at):
    """The gradients of :func:`combine_fwd` at ``g`` (n_tok, d): ``d_ye``
    (n_slot, d) in ye's dtype and ``d_w`` (n_tok,) fp32."""
    n_tok, k = slot.shape
    n_slot, d = ye.shape
    if _cost.shape_only(ye):
        _report_combine_bwd(ye, slot)
        return ye.new_empty((n_slot, d)), w.new_empty((n_tok,))
    _check(ye, slot, token_at)
    g = g.to(ye.dtype).contiguous()
    ye, w = ye.contiguous(), w.to(torch.float32).contiguous()
    slot, token_at = slot.contiguous(), token_at.contiguous()
    d_ye = torch.empty_like(ye)
    d_w = torch.empty((n_tok,), dtype=torch.float32, device=ye.device)
    _launch(_lib().moe_combine_bwd_launch, g.data_ptr(), ye.data_ptr(),
            w.data_ptr(), slot.data_ptr(), token_at.data_ptr(),
            d_ye.data_ptr(), d_w.data_ptr(), n_tok, k, n_slot, d,
            int(ye.dtype == torch.bfloat16), device=ye.device)
    combine_bwd.launches += 1
    _report_combine_bwd(ye, slot)
    return d_ye, d_w


combine_bwd.launches = 0


# The work of a launch: each output row written once and each input row
# read once; a sum reads the n_tok * k rows its pairs name (the kept ones
# fewer, which only the device knows), and the indices and weights.

def _report_gather(x, n_out, weighted):
    if _cost.active():
        n_src, d = x.shape
        row = d * x.element_size()
        _cost.report("moe_gather_rows", n_out * d if weighted else 0,
                     (n_out + n_src) * row + 8 * n_out
                     + (4 * n_src if weighted else 0))


def _report_sum(src, slot, w):
    if _cost.active():
        (n_tok, k), d = slot.shape, src.shape[1]
        row = d * src.element_size()
        _cost.report("moe_sum_rows", (2 if w is not None else 1) * n_tok * k * d,
                     (n_tok * k + n_tok) * row + 8 * n_tok * k
                     + (4 * n_tok if w is not None else 0))


def _report_combine_bwd(ye, slot):
    if _cost.active():
        (n_tok, k), (n_slot, d) = slot.shape, ye.shape
        row = d * ye.element_size()
        # g read, ye's n_tok * k rows read, d_ye written; d_ye's products
        # and d_w's multiply-adds
        _cost.report("moe_combine_bwd", n_slot * d + 2 * n_tok * k * d,
                     (n_tok + n_tok * k + n_slot) * row
                     + 8 * (n_tok * k + n_slot) + 8 * n_tok)
