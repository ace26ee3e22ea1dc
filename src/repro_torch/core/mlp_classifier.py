"""Supervised replication-count learning (paper Section 3.1.1, Eqs. 3-4).

The paper: "When substantial labeled training data is present, a
Multilayered Perceptron works reasonably well" -- a softmax classifier
P_j(t_i) = exp(F_i . W_j) / sum_k exp(F_i . W_k) trained with cross-entropy
(Eq. 4) and Adam.  Once a site has accumulated (task features -> chosen
replication count) history, this learner distills the clustering policy
and amortizes it to O(1) per task.

Counterpart of ``repro.core.mlp_classifier``: an ``nn.Module`` (one tanh
hidden layer, a linear head) trained full batch in fp32 by autograd with the
same hand-rolled Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction at step
t), ``epochs`` steps.  The JAX package draws its initial weights from
``jax.random``, which torch cannot reproduce: here they come from a
``torch.Generator`` seeded with ``cfg.seed``, and :func:`params_from_jax`
loads JAX's instead.  No kernel sits on this path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

__all__ = ["MLPConfig", "ReplicationMLP", "params_from_jax"]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_features: int
    n_classes: int           # max replication count
    hidden: int = 32
    lr: float = 1e-2
    epochs: int = 300
    seed: int = 0


class _Net(nn.Module):
    """logits = tanh(x @ w1 + b1) @ w2 + b2, with JAX's (in, out) layout."""

    def __init__(self, cfg: MLPConfig, device):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        s1 = 1.0 / np.sqrt(cfg.n_features)
        s2 = 1.0 / np.sqrt(cfg.hidden)

        def normal(*shape, scale):
            return nn.Parameter(scale * torch.randn(
                *shape, generator=gen, device=device))

        self.w1 = normal(cfg.n_features, cfg.hidden, scale=s1)
        self.b1 = nn.Parameter(torch.zeros(cfg.hidden, device=device))
        self.w2 = normal(cfg.hidden, cfg.n_classes, scale=s2)
        self.b2 = nn.Parameter(torch.zeros(cfg.n_classes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


def _loss(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Eq. (4): mean cross-entropy of the softmax in Eq. (3)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(y_onehot * logp, dim=-1))


def params_from_jax(tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """JAX's parameter dict (``w1``, ``b1``, ``w2``, ``b2`` as numpy arrays)
    as fp32 tensors on ``device``, for ``ReplicationMLP.load``."""
    return {k: torch.tensor(np.array(v, np.float32), device=device)
            for k, v in tree.items()}


class ReplicationMLP:
    """Fit on (features, counts) pairs; predict counts for new tasks.

    ``losses`` holds the loss before each of the last fit's Adam steps."""

    def __init__(self, cfg: MLPConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.net = _Net(cfg, self.device)
        self.mean = np.zeros(cfg.n_features)
        self.scale = np.ones(cfg.n_features)
        self.losses: list[float] = []

    def load(self, params: dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.net.named_parameters():
                p.copy_(params[name])

    def _inputs(self, features: np.ndarray) -> torch.Tensor:
        x = (np.asarray(features, np.float32) - self.mean) / self.scale
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def fit(self, features: np.ndarray, counts: np.ndarray) -> float:
        x = np.asarray(features, np.float32)
        self.mean = x.mean(0)
        self.scale = np.where(x.std(0) < 1e-9, 1.0, x.std(0))
        xt = self._inputs(x)
        y = torch.nn.functional.one_hot(
            torch.as_tensor(np.asarray(counts, np.int64) - 1,
                            device=self.device),
            self.cfg.n_classes).to(torch.float32)
        params = list(self.net.parameters())
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        b1, b2, eps, lr = 0.9, 0.999, 1e-8, self.cfg.lr
        self.losses = []
        for t in range(1, self.cfg.epochs + 1):
            loss = _loss(self.net(xt), y)
            grads = torch.autograd.grad(loss, params)
            self.losses.append(float(loss.detach()))
            with torch.no_grad():
                for p, g, m_, v_ in zip(params, grads, m, v):
                    m_.mul_(b1).add_((1 - b1) * g)
                    v_.mul_(b2).add_((1 - b2) * g * g)
                    mh = m_ / (1 - b1 ** t)
                    vh = v_ / (1 - b2 ** t)
                    p.sub_(lr * mh / (torch.sqrt(vh) + eps))
        with torch.no_grad():
            return float(_loss(self.net(xt), y))

    def logits(self, features: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.net(self._inputs(features)).cpu().numpy()

    def predict(self, features: np.ndarray) -> np.ndarray:
        return np.argmax(self.logits(features), -1) + 1

    def accuracy(self, features: np.ndarray, counts: np.ndarray) -> float:
        return float(np.mean(self.predict(features) == np.asarray(counts)))
