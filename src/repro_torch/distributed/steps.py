"""Train, prefill and serve step factories (counterparts of
``repro.distributed.steps``).

PyTorch runs eagerly, so a factory returns a plain closure over the model
functions; there is nothing to compile, and the optional inputs that JAX
fixes at trace time are optional arguments here.  The train step has no
``grad_shardings``: sharding waits for the port's sharding layer.
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update, cosine_schedule
from ..tree import flatten, tree_map, unflatten

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                    accum_steps: int = 1, q_chunk: int = 1024,
                    xent_chunk: int = 512, warmup: int = 100,
                    total_steps: int = 10_000):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient by autograd through
    ``lm.forward_train``, then :func:`~repro_torch.optim.adamw_update` at the
    cosine schedule's scale of the step count before the update.

    ``batch`` holds numpy arrays or tensors (the pipeline's), moved to the
    params' device.  ``accum_steps > 1`` runs the microbatches (equal row
    slices of the batch, in order) one after another, adds their gradients
    into an fp32 sum and takes the mean of gradients and losses, so
    activation memory is that of one microbatch.  The returned trees are
    new; the inputs are left as they were (the coordinator's NaN guard
    keeps them to reject a step)."""
    lm.check_train_family(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def grads_of(params, mb):
        leaves = [t.detach().requires_grad_() for _, t in flatten(params)]
        loss, _ = lm.forward_train(unflatten(params, leaves), cfg, mb,
                                   q_chunk=q_chunk, xent_chunk=xent_chunk)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        device = flatten(params)[0][1].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            mbs = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum_steps):
                l, g = grads_of(params, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        lr_scale = cosine_schedule(int(opt_state["step"]), warmup=warmup,
                                   total=total_steps)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state, lr_scale=lr_scale)
        return params, opt_state, {"loss": loss, **om}

    return train_step


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
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(params, batch, last_idx=None)``; ``last_idx`` (B,)
    picks each row's true last prompt position (bucket-padded prompts, see
    ``lm.prefill``)."""

    def prefill_step(params, batch, last_idx=None):
        return lm.prefill(params, cfg, batch, cache_len, last_idx=last_idx)

    return prefill_step
