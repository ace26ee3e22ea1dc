"""The adapter to the program for a training cell.

:class:`System` builds the train step as the port's launcher builds it
(``repro_torch.launch.train.build``: ``make_train_step`` at ``q_chunk =
min(1024, seq_len)``, ``xent_chunk = 512``, AdamW at the launcher's
defaults, on the card after ``make_deterministic()``), from the benchmark's
seeded params, and calls it as the coordinator calls it
(``ft/coordinator.py``): a host batch in, the step's loss copied to the
host before the next step, the new state kept only when that loss is
finite.  There are no checkpoints and no faults.

The first ``setup_steps`` steps go through the same call on the traffic's
first batches; they warm every shape and give the program's side of the
comparison (:func:`port_bench.judge.compare`): each step's loss, each
leaf's norm of the first clipped gradient (from AdamW's first moment after
one step: ``mu = (1 - b1) g``) and each leaf's norm of the parameters'
change over those steps.  :func:`reference_readings` gives the same from
the plain reference, on params drawn again from the seed.
"""
from __future__ import annotations

import dataclasses
import tempfile

import torch

from .. import arch, spec, traffic as gen, weights
from ..model import Model

__all__ = ["System", "program_config", "reference_readings"]


def program_config(m: Model):
    """The port's ``ModelConfig`` of the benchmark's :class:`Model`: its
    fields, and each ``run`` key of ``m.arch`` by name (a key the port's
    config lacks raises, naming it)."""
    from repro_torch.models.config import ModelConfig
    have = {f.name for f in dataclasses.fields(ModelConfig)}
    lacking = sorted(set(m.passed) - have)
    if lacking:
        raise ValueError(f"the port's ModelConfig has no field "
                         f"{', '.join(lacking)} (configuration {m.name!r})")
    return ModelConfig(
        name=m.name, family=m.family, n_layers=m.n_layers, d_model=m.d_model,
        n_heads=m.n_heads, n_kv_heads=m.n_kv_heads, d_ff=m.d_ff,
        vocab_size=m.vocab_size, head_dim=m.head_dim,
        block_type=m.block_type,
        norm_type=m.norm_type, mlp_type=m.mlp_type, use_bias=m.use_bias,
        tie_embeddings=m.tie_embeddings, rope_theta=m.rope_theta,
        n_experts=m.n_experts, top_k=m.top_k,
        capacity_factor=m.capacity_factor, param_dtype=m.param_dtype,
        compute_dtype=m.compute_dtype, remat=m.remat,
        **{k: m.arch[k] for k in m.passed})


def _launcher_args(traffic: dict, seed: int, device: str, ckpt_dir: str):
    from repro_torch.launch import train as launch
    opt = traffic["optimizer"]
    return launch.build_parser().parse_args([
        "--global-batch", str(traffic["batch"]),
        "--seq-len", str(traffic["seq_len"]),
        "--steps", str(opt["total_steps"]), "--lr", repr(opt["lr"]),
        "--seed", str(seed & gen.SEED_MASK), "--device", device,
        "--ckpt-dir", ckpt_dir])


def _check_optimizer(opt: dict) -> None:
    """The program's AdamW settings are the traffic file's."""
    from repro_torch.optim import AdamWConfig
    have = AdamWConfig()
    for key in ("b1", "b2", "eps", "weight_decay", "grad_clip"):
        if getattr(have, key) != opt[key]:
            raise ValueError(f"the program's AdamW {key} is "
                             f"{getattr(have, key)}, the traffic states "
                             f"{opt[key]}")


def _norms(tree, scale: float = 1.0) -> dict:
    return {p: float(torch.linalg.vector_norm(t)) * scale
            for p, t in weights.flat(tree).items()}


class System:
    """The program's train step on seeded params, called step by step."""

    def __init__(self, m: Model, traffic: dict, seed: int, device: str):
        from repro_torch.launch import train as launch
        _check_optimizer(traffic["optimizer"])
        self.m, self.traffic, self.seed = m, traffic, seed
        self.device = device
        self.index = 0
        self.tokens_per_step = gen.tokens_per_step(traffic)
        self._ckpt = tempfile.TemporaryDirectory(prefix="port_bench_ckpt_")
        args = _launcher_args(traffic, seed, device, self._ckpt.name)
        params = weights.draw(m, seed, device)
        built = launch.build(program_config(m), args, params=params)
        self.step_fn = built["step_fn"]
        self.params = built["coord"].params
        self.opt_state = built["coord"].opt_state

    def next_batch(self) -> dict:
        batch = gen.batch_at(self.traffic, self.m.vocab_size, self.seed,
                             self.index)
        self.index += 1
        return batch

    def call(self, batch):
        """The step on ``batch``: (new state, loss tensor), nothing kept."""
        params, opt_state, metrics = self.step_fn(self.params,
                                                  self.opt_state, batch)
        return (params, opt_state), metrics["loss"]

    def adopt(self, state) -> None:
        self.params, self.opt_state = state

    def setup_steps(self) -> dict:
        """The first steps, through :meth:`call`; the program's readings,
        with each MoE layer's routes of each step (the program's
        ``layers.route_log``, on only for these steps)."""
        from repro_torch.models import layers
        losses, grads, routes = [], None, [] if self.m.is_moe else None
        b1 = self.traffic["optimizer"]["b1"]
        for i in range(int(self.traffic["setup_steps"])):
            batch = self.next_batch()
            if routes is not None:
                layers.route_log = []
            try:
                state, loss_t = self.call(batch)
            finally:
                log, layers.route_log = layers.route_log, None
            if routes is not None:
                # the forward's calls, one an MoE layer (the recompute's
                # follow)
                routes.append([r["experts"] for r in log[:arch.moe_layers(self.m)]])
            loss = float(loss_t)
            losses.append(loss)
            if loss == loss and abs(loss) != float("inf"):
                self.adopt(state)
            del state
            if i == 0:
                grads = _norms(self.opt_state["mu"], 1.0 / (1.0 - b1))
        return {"losses": losses, "grad_norms": grads, "routes": routes,
                "delta_norms": _delta_norms(self.m, self.params, self.seed,
                                            self.device)}

    def close(self) -> None:
        """Free the program's state on the card."""
        self.step_fn = self.params = self.opt_state = None
        self._ckpt.cleanup()


def _delta_norms(m: Model, params, seed: int, device) -> dict:
    """Each leaf's norm of its change since the seeded draw (the draw made
    again a leaf at a time)."""
    flat = weights.flat(params)
    out = {}
    for path, shape, fan_in in arch.leaf_specs(m):
        if shape is None:
            continue
        start = weights.draw_leaf(path, shape, fan_in, seed, device)
        out[path] = float(torch.linalg.vector_norm(
            flat[path].float() - start))
        del start
    return out


def reference_readings(m: Model, traffic: dict, seed: int, device: str,
                       mm_name: str = "plain", routes=None) -> dict:
    """The plain reference's readings of the first ``setup_steps`` steps
    (``mm_name`` "fp8": the control, its products in fp8), its MoE layers
    on ``routes`` (the program's, where given) with the gap of those routes
    in its own logits."""
    ref = spec.module("reference", m.reference)
    ref.exact_fp32()
    mm = {"plain": ref.plain_mm, "fp8": ref.fp8_mm}[mm_name]
    params = weights.draw(m, seed, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in
                gen.batch_at(traffic, m.vocab_size, seed, i).items()}
               for i in range(int(traffic["setup_steps"]))]
    losses, grads, used, gap = ref.train_steps(
        m, traffic["optimizer"], params, batches, mm, routes)
    return {"losses": losses, "grad_norms": grads,
            "routes": used if m.is_moe else None,
            "route_gap": gap if routes else None,
            "delta_norms": _delta_norms(m, params, seed, device)}

