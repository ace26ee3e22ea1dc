"""AdamW on nested dicts of tensors (counterpart of ``repro.optim.adamw``).

Moments are fp32 and mirror the params' structure.  The update is **out of
place**: it returns new params and a new state and leaves its inputs as
they were, as JAX's pure function does.  The training coordinator relies on
that: its NaN/Inf guard rejects a step by keeping the old trees, which an
in-place update would already have overwritten.  It costs one more copy of
params, mu and nu while the step runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tree import flatten, tree_map, unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "state_from_jax"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, *, master: bool = False):
    """``{"mu", "nu"}``: fp32 zeros like ``params``; ``"step"``: a 0-d int32
    tensor on the host (the schedule and the bias corrections are host
    scalars); ``master=True`` adds an fp32 copy of the params."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32)}
    if master:
        state["master"] = tree_map(lambda p: p.to(torch.float32).clone(),
                                   params)
    return state


def state_from_jax(np_state, device="cuda"):
    """Map a JAX ``adamw_init``/``adamw_update`` state, converted to numpy,
    onto the port's: moments (and master) on ``device``, the step on the
    host."""
    conv = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device)
    out = {"mu": tree_map(conv, np_state["mu"]),
           "nu": tree_map(conv, np_state["nu"]),
           "step": torch.tensor(int(np.asarray(np_state["step"])),
                                dtype=torch.int32)}
    if "master" in np_state:
        out["master"] = tree_map(conv, np_state["master"])
    return out


def _decay_mask(path) -> bool:
    """No weight decay on norms / biases / scalar gains: JAX's rule on the
    same leaf names (a substring test on the last path element, so every
    leaf whose name holds a ``u``, ``w_up`` among them, is left undecayed,
    as in JAX)."""
    leaf = str(path[-1]) if path else ""
    return not any(s in leaf for s in ("scale", "bias", "ln_", "lam", "ww",
                                       "mu", "u"))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's fp32 sum of
    squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for _, x in flatten(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """Returns (new_params, new_state, {"grad_norm"}); the inputs are left
    unchanged.  Host scalars (bias corrections, the learning rate) are
    float32, as JAX computes them."""
    f32 = np.float32
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = int(state["step"]) + 1
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(step))
    lr = float(f32(cfg.lr) * f32(lr_scale))
    has_master = "master" in state
    masters = state["master"] if has_master else params
    flat = zip(flatten(params), flatten(grads), flatten(state["mu"]),
               flatten(state["nu"]), flatten(masters))
    new_p, new_mu, new_nu, new_m = [], [], [], []
    for (path, p), (_, g), (_, mu), (_, nu), (_, m) in flat:
        g = g.to(torch.float32) * scale
        mu2 = cfg.b1 * mu + (1.0 - cfg.b1) * g
        nu2 = cfg.b2 * nu + (1.0 - cfg.b2) * g * g
        update = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        src = m.to(torch.float32)
        if _decay_mask(path):
            update = update + cfg.weight_decay * src
        m2 = src - lr * update
        new_p.append(m2.to(p.dtype))
        new_mu.append(mu2)
        new_nu.append(nu2)
        new_m.append(m2)
    new_state = {"mu": unflatten(params, new_mu),
                 "nu": unflatten(params, new_nu),
                 "step": torch.tensor(step, dtype=torch.int32)}
    if has_master:
        new_state["master"] = unflatten(params, new_m)
    return unflatten(params, new_p), new_state, {"grad_norm": gnorm}
