"""Train, prefill and serve step factories (counterparts of
``repro.distributed.steps``).

PyTorch runs eagerly, so a factory returns a plain closure over the model
functions; there is nothing to compile, and the optional inputs that JAX
fixes at trace time are optional arguments here.  On DTensor params (laid
out by ``distributed.params``, inside ``sharding.use_rules``) the steps lay
the batch out by ``batch_specs`` and run the same model code sharded;
``grad_shardings`` places the accumulated gradient as JAX's constraint
does.
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..obs import trace
from ..optim import AdamWConfig, adamw_update, cosine_schedule
from ..tree import flatten, tree_map, unflatten
from .sharding import (dtensor_zeros, is_dtensor, placements_for,
                       redistribute, replicated)

__all__ = ["make_grad_fn", "make_prefill_step", "make_serve_step",
           "make_train_step"]


def make_grad_fn(cfg: ModelConfig, *, q_chunk: int = 1024,
                 xent_chunk: int = 512):
    """Returns ``grads_of(params, batch) -> (loss, grads)``: JAX's
    ``value_and_grad`` of ``lm.forward_train`` by autograd.  ``batch``
    holds tensors on the params' device; the grads are a new tree of the
    params' structure and dtypes."""
    lm.check_train_family(cfg)

    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_() for _, t in flatten(params)]
        with trace.range("train.forward"):
            loss, _ = lm.forward_train(unflatten(params, leaves), cfg, batch,
                                       q_chunk=q_chunk,
                                       xent_chunk=xent_chunk)
            if is_dtensor(loss):
                loss = replicated(loss)
        # a leaf the loss does not reach (the cross-attention's q/k/v
        # biases) gets zeros, as JAX's gradient gives it
        with trace.range("train.backward"):
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), unflatten(params, list(grads))

    return grads_of


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                    accum_steps: int = 1, q_chunk: int = 1024,
                    xent_chunk: int = 512, warmup: int = 100,
                    total_steps: int = 10_000, grad_shardings=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient by autograd through
    ``lm.forward_train``, then :func:`~repro_torch.optim.adamw_update` at the
    cosine schedule's scale of the step count before the update.

    ``batch`` holds numpy arrays or tensors (the pipeline's, with the
    encoder-decoder's frames or the image family's embeddings), moved to
    the params' device.  ``accum_steps > 1`` runs the microbatches (equal row
    slices of the batch, in order) one after another, adds their gradients
    into an fp32 sum and takes the mean of gradients and losses, so
    activation memory is that of one microbatch.  The returned trees are
    new; the inputs are left as they were (the coordinator's NaN guard
    keeps them to reject a step).

    On DTensor params the batch is laid out by ``batch_specs`` on their
    mesh (every rank holds the same global batch and keeps its rows).
    ``grad_shardings`` (a tree of placements mirroring the params, e.g.
    ``params.param_shardings`` of the full specs) places the fp32 gradient
    sum at its creation and each microbatch's gradient before it is added,
    as JAX's constraint in the accumulation scan does: under ZeRO-1 the
    per-microbatch reduction then lands as a reduce-scatter onto the
    optimizer's shards.  As in JAX it acts only when ``accum_steps > 1``."""
    lm.check_train_family(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    grads_of = make_grad_fn(cfg, q_chunk=q_chunk, xent_chunk=xent_chunk)

    def train_step(params, opt_state, batch):
        with trace.range("train.step"):
            first = flatten(params)[0][1]
            device = first.device
            with trace.range("train.h2d"):
                batch = {k: torch.as_tensor(v).to(device)
                         for k, v in batch.items()}
            if accum_steps == 1:
                loss, grads = grads_of(params, _laid_out(batch, first))
            else:
                mbs = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                    *v.shape[1:]) for k, v in batch.items()}
                grads = (tree_map(_zeros_f32, params)
                         if grad_shardings is None
                         else tree_map(_zeros_f32, params, grad_shardings))
                loss = torch.zeros((), dtype=torch.float32, device=device)
                for i in range(accum_steps):
                    l, g = grads_of(params, _laid_out(
                        {k: v[i] for k, v in mbs.items()}, first))
                    tree_map(lambda acc, x: acc.add_(_placed_like(x, acc)),
                             grads, g)
                    loss = loss + l
                grads = tree_map(lambda g: g / accum_steps, grads)
                loss = loss / accum_steps
            with trace.range("train.optimizer"):
                lr_scale = cosine_schedule(int(opt_state["step"]),
                                           warmup=warmup, total=total_steps)
                params, opt_state, om = adamw_update(
                    opt_cfg, params, grads, opt_state, lr_scale=lr_scale)
            return params, opt_state, {"loss": loss, **om}

    return train_step


def _laid_out(batch, like):
    """``batch`` as DTensors by ``batch_specs`` on the mesh of DTensor
    ``like`` (plain tensors otherwise)."""
    if not is_dtensor(like):
        return batch
    from .params import batch_specs, distribute_tree
    mesh = like.device_mesh
    return distribute_tree(batch, batch_specs(batch, mesh), mesh)


def _zeros_f32(p, placements=None):
    """fp32 zeros of ``p``'s shape (a DTensor at ``placements``, default
    ``p``'s, for a DTensor ``p``)."""
    if not is_dtensor(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return dtensor_zeros(p.shape, torch.float32, p.device_mesh,
                         placements or p.placements)


def _placed_like(x, acc):
    return redistribute(x, acc.placements) if is_dtensor(acc) else x


def _greedy(logits):
    """argmax over the vocabulary (a DTensor's vocabulary gathered first,
    its batch rows kept: the first maximum, as on one device)."""
    if is_dtensor(logits):
        logits = redistribute(logits, placements_for(logits, {0}))
    return torch.argmax(logits, dim=-1)


def make_serve_step(cfg: ModelConfig, *, cache_axes=None):
    """One greedy decode step: (params, cache, tokens (B,1), pos, live=None)
    -> (next_tokens (B,1) int32, logits fp32, cache).  ``pos`` may be a
    Python int (static batch) or a (B,) tensor (continuous batching).

    A ``live`` (B,) bool argument commits cache writes for live rows only.
    The commit is made **in place**: the decode writes the new K/V entry or
    recurrent state of each live row into the cache along that leaf's batch
    axis and never touches an idle row, so a freed slot keeps its previous
    row bit-identical (JAX computes every row and selects with ``where``;
    the result is the same).  ``cache_axes`` (the per-leaf batch axes from
    ``repro_torch.serve.snapshot.cache_batch_axes``) is checked against the
    axes that commit writes (``lm.commit_axes``)."""
    if cache_axes is not None and dict(cache_axes) != lm.commit_axes(cfg):
        raise ValueError(f"the in-place commit writes batch axes "
                         f"{lm.commit_axes(cfg)}; the cache has {cache_axes}")

    def serve_step(params, cache, tokens, pos, live=None):
        logits, cache = lm.decode_step(params, cfg, cache, tokens, pos,
                                       live=live)
        nxt = _greedy(logits).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(params, batch, last_idx=None)``; ``last_idx`` (B,)
    picks each row's true last prompt position (bucket-padded prompts, see
    ``lm.prefill``).  On DTensor params the batch is laid out by
    ``batch_specs``."""

    def prefill_step(params, batch, last_idx=None):
        batch = _laid_out(batch, flatten(params)[0][1])
        return lm.prefill(params, cfg, batch, cache_len, last_idx=last_idx)

    return prefill_step
