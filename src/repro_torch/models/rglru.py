"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  Block: x -> [linear -> GeLU gate]
* [linear -> causal depthwise conv(4) -> RG-LRU] -> linear out.  The RG-LRU
recurrence

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is a per-channel linear recurrence.  Prefill and training run it on the
RG-LRU scan kernel (``kernels/rglru_scan``) where the JAX model uses
``jax.lax.associative_scan``; under autograd its gradient is the scan's
backward kernel (``lru_ops.lru_scan`` goes through ``_LruScan``), and the
gates and the causal conv differentiate as plain torch ops.  Decode carries
``h`` explicitly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import (constrain, is_dtensor, local_call,
                                    placements_for)
from ..kernels.rglru_scan import ops as lru_ops
from .config import ModelConfig
from .layers import dense_init

_C = 8.0


def init_rglru_block(generator, cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width
    dev = generator.device
    return {
        "w_gate_branch": dense_init((d, w), generator),
        "w_rec_branch": dense_init((d, w), generator),
        "conv_w": 0.1 * dense_init((cfg.conv_width, w), generator),
        "conv_b": torch.zeros((w,), dtype=torch.float32, device=dev),
        "wa": dense_init((w, w), generator),
        # bias toward remembering
        "ba": torch.full((w,), 2.0, dtype=torch.float32, device=dev),
        "wx": dense_init((w, w), generator),
        "bx": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lam": torch.linspace(0.9, 4.0, w, dtype=torch.float32, device=dev),
        "w_out": dense_init((w, d), generator),
    }


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _gates(p, u, dtype):
    """(a, b) of the recurrence, both fp32: ``h_t = a_t h_{t-1} + b_t``."""
    r = torch.sigmoid((u @ p["wa"].to(dtype)).to(torch.float32) + p["ba"])
    i = torch.sigmoid((u @ p["wx"].to(dtype)).to(torch.float32) + p["bx"])
    log_a = -_C * F.softplus(p["lam"]) * r                   # (..., W) fp32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * u.to(torch.float32)


def _conv_train(p, u, dtype):
    """Causal depthwise conv over time; u: (B, S, W).  ``conv_w[i]``
    multiplies the input delayed by ``width - 1 - i``."""
    width = p["conv_w"].shape[0]
    s = u.shape[1]
    out = None
    for i in range(width):
        shifted = F.pad(u, (0, 0, width - 1 - i, i))[:, :s]
        term = shifted * p["conv_w"][i].to(dtype)
        out = term if out is None else out + term
    return out + p["conv_b"].to(dtype)


def _scan(a, b):
    """The RG-LRU scan kernel; on DTensors it runs on each rank's batch rows
    and channels (the recurrence is per channel), the sequence whole."""
    if not is_dtensor(a):
        return lru_ops.lru_scan(a, b)
    from torch.distributed.tensor import Shard
    pl = placements_for(a, {0, 2})
    last = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
            for q in pl]
    return local_call(lru_ops.lru_scan, (a, b), (pl, pl), (pl, last))


def rglru_block_forward(p, x, cfg: ModelConfig, *, return_state=False):
    """Prefill path.  Returns (out, state) where state is the decode carry
    ``{"h": (B, W) fp32, "conv": (B, conv_width - 1, W)}`` (or the fp32 last
    ``h`` alone without ``return_state``, as in JAX)."""
    dtype = x.dtype
    gate = _gelu(x @ p["w_gate_branch"].to(dtype))
    u_raw = constrain(x @ p["w_rec_branch"].to(dtype),
                      ("batch", "seq", "lru"))
    u = _conv_train(p, u_raw, dtype)
    a, b = _gates(p, u, dtype)                    # (B, S, W) fp32
    h, h_last = _scan(a, b)
    h = constrain(h.to(dtype), ("batch", "seq", "lru"))
    out = constrain((gate * h) @ p["w_out"].to(dtype),
                    ("batch", "seq", "embed"))
    if not return_state:
        return out, h[:, -1].to(torch.float32)
    width = p["conv_w"].shape[0]
    conv_tail = u_raw[:, -(width - 1):]
    pad = (width - 1) - conv_tail.shape[1]
    if pad > 0:
        conv_tail = F.pad(conv_tail, (0, 0, pad, 0))
    # JAX keeps h[:, -1] after the cast to the compute dtype
    return out, {"h": h[:, -1].to(torch.float32), "conv": conv_tail}


def rglru_block_decode(p, x, state, cfg: ModelConfig):
    """One-step decode.  x: (B, 1, D); state = {"h": (B, W) fp32,
    "conv": (B, conv_width - 1, W)} (previous conv inputs, oldest first)."""
    dtype = x.dtype
    gate = _gelu(x[:, 0] @ p["w_gate_branch"].to(dtype))
    u_new = x[:, 0] @ p["w_rec_branch"].to(dtype)                # (B, W)
    width = p["conv_w"].shape[0]
    hist = torch.cat([state["conv"].to(dtype), u_new[:, None]], 1)
    u = hist[:, 0] * p["conv_w"][0].to(dtype)
    for i in range(1, width):
        u = u + hist[:, i] * p["conv_w"][i].to(dtype)
    u = u + p["conv_b"].to(dtype)
    a, bterm = _gates(p, u, dtype)                               # (B, W)
    h = a * state["h"] + bterm
    out = (gate * h.to(dtype)) @ p["w_out"].to(dtype)
    return out[:, None], {"h": h, "conv": hist[:, 1:]}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}
