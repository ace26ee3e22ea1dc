"""Sharded equals unsharded, on real ranks: four CPU processes with gloo
on a 2x2 ("data", "model") mesh, each holding DTensor shards laid out by
``distributed.params``, against the mesh-less port on the same inputs.

Both compute in fp32 (the tiny configs' bf16 would put one-ulp rounding
flips, and the MoE top-k choices they move, above the fp32 tolerance; the
card's bf16 path is held bit for bit on a one-rank mesh in
``chip_smoke.py``).

* tiny olmo-1b and granite-moe-1b (experts on ``model``) train two steps
  with ``accum_steps=2`` and ``grad_shardings`` (ZeRO-1 on and off): the
  losses and the ``full_tensor()`` params equal the mesh-less steps' within
  fp32 ``atol=rtol=2e-4``, and the new params keep their placements;
* tiny olmo-1b prefills and decodes 8 steps with a ``live`` mask: the
  tokens equal the mesh-less ones, an idle row's cache stays bit-identical
  while it is idle, and the cache keeps the placements of ``cache_specs``.
"""
import pytest

torch = pytest.importorskip("torch")

TOL = 2e-4
WORLD = 4


def _train_case(arch, zero1, mesh):
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import spec_to_placements, use_rules
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten

    cfg = _fp32(get_config(arch, tiny=True))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw_init(params, master=True)
    batches = [make_batch(cfg, batch=4, seq=32, seed=s) for s in (1, 2)]
    step = make_train_step(cfg, accum_steps=2, total_steps=10)
    p, o, ref_loss = params, opt, []
    for b in batches:
        p, o, m = step(p, o, b)
        ref_loss.append(float(m["loss"]))
    pd = pshard.distribute_params(params, mesh, zero1=zero1)
    od = pshard.distribute_opt_state(opt, params, mesh)
    step = make_train_step(cfg, accum_steps=2, total_steps=10,
                           grad_shardings=pshard.param_shardings(params,
                                                                 mesh))
    loss = []
    with use_rules(mesh):
        for b in batches:
            pd, od, m = step(pd, od, b)
            loss.append(float(m["loss"]))
    specs = pshard.param_specs(params, mesh, zero1=zero1)
    errs, placed = [], True
    for (path, want), (_, got), (_, spec) in zip(flatten(p), flatten(pd),
                                                 flatten(specs)):
        full = got.full_tensor()
        errs.append(float(((full - want).abs()
                           - TOL * want.abs()).max()))
        placed &= list(got.placements) == spec_to_placements(spec, mesh)
    return {"loss": loss, "ref_loss": ref_loss, "param_excess": max(errs),
            "placed": placed}


def _decode_case(mesh):
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import spec_to_placements, use_rules
    from repro_torch.distributed.steps import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import lm

    cfg = _fp32(get_config("olmo-1b", tiny=True))
    params = lm.cast_params(
        lm.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    prompt = {"tokens": make_batch(cfg, batch=4, seq=16, seed=3)["tokens"]}
    prefill, serve = make_prefill_step(cfg, 32), make_serve_step(cfg)
    live_at = [torch.tensor([True, i not in (2, 3, 4), True, i < 6])
               for i in range(8)]

    def run(p, batch, scope):
        with scope:
            logits, cache = prefill(p, batch)
            tok = torch.argmax(_full(logits), -1).to(torch.int32)[:, None]
            toks, pos, idle_same = [tok], torch.full((4,), 16), True
            for live in live_at:
                before = {k: _full(v).clone() for k, v in cache.items()}
                nxt, _, cache = serve(p, cache, tok, pos, live)
                nxt = _full(nxt)
                tok = torch.where(live[:, None], nxt, tok)
                pos = pos + live.to(pos.dtype)
                toks.append(tok)
                for k, v in cache.items():
                    idle = ~live
                    idle_same &= torch.equal(_full(v)[:, idle],
                                             before[k][:, idle])
        return torch.cat(toks, 1), cache, idle_same

    import contextlib
    want, _, _ = run(params, prompt, contextlib.nullcontext())
    pd = pshard.distribute_params(params, mesh)
    batch = pshard.distribute_tree(prompt, pshard.batch_specs(prompt, mesh),
                                   mesh)
    got, cache, idle_same = run(pd, batch, use_rules(mesh))
    specs = pshard.cache_specs(cache, cfg, mesh)
    placed = all(list(v.placements) == spec_to_placements(specs[k], mesh)
                 for k, v in cache.items())
    return {"tokens": got.tolist(), "ref_tokens": want.tolist(),
            "idle_same": idle_same, "placed": placed}


def _fp32(cfg):
    """fp32 compute, so that the sharded and the unsharded sums differ by
    fp32 rounding only (in bf16 a one-ulp difference can flip a rounding
    and, in the MoE layer, a top-k choice)."""
    import dataclasses
    return dataclasses.replace(cfg, compute_dtype="float32")


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _worker(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {"decode": _decode_case(mesh)}
        for arch in ("olmo-1b", "granite-moe-1b-a400m"):
            for zero1 in (False, True):
                out[f"{arch}/zero1={zero1}"] = _train_case(arch, zero1, mesh)
        torch.save(out, f"{tmp}/r{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh")
    mp.start_processes(_worker, args=(WORLD, str(tmp)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(tmp / f"r{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("case", [f"{a}/zero1={z}"
                                  for a in ("olmo-1b", "granite-moe-1b-a400m")
                                  for z in (False, True)])
def test_sharded_train_steps_equal_meshless(results, case):
    for rank, out in enumerate(results):
        r = out[case]
        assert r["loss"] == pytest.approx(r["ref_loss"], abs=TOL, rel=TOL), \
            (rank, r)
        assert r["param_excess"] <= TOL, (rank, r["param_excess"])
        assert r["placed"], rank


def test_sharded_decode_equals_meshless(results):
    for rank, out in enumerate(results):
        r = out["decode"]
        assert r["tokens"] == r["ref_tokens"], rank
        assert r["idle_same"], rank
        assert r["placed"], rank
