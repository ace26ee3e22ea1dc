"""Plain PyTorch versions of the MoE layer's dispatch and combine.

``dispatch`` gathers each slot's token row; ``combine`` gathers each (token,
choice) pair's expert row, casts to fp32, weights it by the sum of the
token's gates and sums over the choices.  Both go through :class:`_Route`,
whose gradient is a gather too (no atomics).  The CUDA kernels in
``csrc/moe_rows.cu`` compute the same functions with the same rounding
points without writing the (token, choice, d) rows.
"""
from __future__ import annotations

import torch

__all__ = ["dispatch", "combine"]


def _pick(x, idx):
    """Rows of ``x`` at ``idx`` (any shape); index ``x.shape[0]`` picks a
    zero row."""
    n = x.shape[0]
    return x[idx.clamp(max=n - 1)].masked_fill_((idx == n)[..., None], 0)


class _Route(torch.autograd.Function):
    """``out[i] = x[idx[i]]`` (a zero row for ``idx[i] == len(x)``); the
    gradient is gathered too: row r of ``dx`` sums the output rows listed in
    ``inv[r]`` (the same sentinel for none) in column order, in fp32, and
    rounds once.  With ``inv`` the exact inverse of ``idx`` this is the
    gather's gradient, reduced in one fixed order without atomics, so a
    train step replays bit for bit."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _pick(x, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        dx = _pick(grad, inv).sum(1, dtype=torch.float32)
        return dx.to(grad.dtype), None, None


def dispatch(x, slot, token_at):
    """x (n_tok, d) into the slots: (n_slot, d) rows ``x[token_at[s]]``, a
    zero row where ``token_at[s] == n_tok``; ``slot`` (n_tok, k) is its
    inverse (``n_slot`` for a dropped pair)."""
    return _Route.apply(x, token_at, slot)


def combine(ye, gate_vals, slot, pair_at):
    """The slots' rows ye (n_slot, d) back to the tokens: shape
    ``gate_vals.shape[:-1] + (d,)``, token t the sum over its kept choices
    j of ``fp32(ye[slot[t, j]])`` times the sum of its gates ``gate_vals[t]``
    (fp32), rounded to ye's dtype once.  ``pair_at`` (n_slot,) is the slots'
    inverse: the pair ``t * k + j`` in each slot, ``n_tok * k`` for none."""
    d = ye.shape[-1]
    got = _Route.apply(ye, slot.reshape(-1), pair_at[:, None])
    got = got.to(torch.float32).reshape(*gate_vals.shape, d)
    weight = gate_vals.sum(-1, keepdim=True)
    return (got * weight[..., None]).sum(-2).to(ye.dtype)
