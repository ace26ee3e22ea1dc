"""The model-level reference of ``chip_smoke.py``
(``phase_model_reference``) on the CPU: its comparison, with the "card"
side run on the CPU too, at tiny widths and the phase's depths (one
layer; recurrentgemma one super block of two recurrent layers and an
attention layer; whisper one encoder and one decoder layer), for all ten
families of ``configs.all_configs``.

Both sides then run the same code on the same device and agree exactly; the
tests hold what the comparison must refuse: one gradient leaf x 1.1, one
logit moved by 1e-2, an MoE route flipped where the CPU's gate gap is above
the near-tie bound, a kept pair dropped with no routing difference before
it in its group.  A route flipped at a gap below the bound is a near-tie:
printed with its token and gap, not a failure, and the family is then held
to the logits of the last token whose routing agreed.

``chip_smoke.py`` is loaded with ``importlib``; it imports no jax.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOKENS = 32
MOE = ("phi35_moe_42b", "granite_moe_1b")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()
_SIDES = {}


def _family(name):
    """(cfg, params, batch) of one family at the phase's depth, tiny."""
    cfg = cs.reference_configs(tiny=True)[name]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, cs.reference_batch(cfg, TOKENS)


def _sides(name):
    """Both sides of one family, run once a module."""
    if name not in _SIDES:
        cfg, params, batch = _family(name)
        _SIDES[name] = (cfg, params, batch,
                        cs.reference_run(params, cfg, batch),
                        cs.reference_run(params, cfg, batch))
    return _SIDES[name]


def _no_logits(pos):
    raise AssertionError("the logits were asked again")


def test_chip_smoke_loads_without_jax():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('cs', "
            f"{str(ROOT / 'chip_smoke.py')!r})\n"
            "cs = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(cs)\n"
            "cs.reference_configs(tiny=True)\n"
            "import repro_torch.distributed.steps\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_reference_configs_cut_depth_only():
    full, tiny = cs.reference_configs(), cs.reference_configs(tiny=True)
    assert set(full) == set(tiny) == set(ARCHS)
    for name, cfg in full.items():
        layers = (cfg.rec_per_attn + 1 if cfg.rglru else 1)
        assert cfg.n_layers == layers
        assert cfg.encoder_layers == (1 if cfg.is_encdec else 0)
        assert cfg.compute_dtype == cfg.param_dtype == "float32"
        assert lm.hybrid_layout(cfg) == ((1, 0) if cfg.rglru else
                                         (0, 1))
    published = cs.reference_configs()["command_r_plus_104b"]
    assert (published.d_model, published.vocab_size) == (12288, 256_000)


@pytest.mark.parametrize("name", ARCHS)
def test_the_comparison_passes_for_every_family(name):
    cfg, params, batch = _family(name)
    rec = cs.reference_family(cfg, params, batch)
    assert rec["near_ties"] == []
    assert rec["logits_err"] == 0.0 and rec["loss_err"] == 0.0
    assert rec["grad_err"] == 0.0
    assert rec["grad_leaves"] == len(flatten(params))
    # the CPU launches no kernel: the plain versions ran
    assert not any(rec["launches"].values())
    assert rec["logits_pos"] == TOKENS - 1


def _floor(grads):
    return cs.REF_GRAD_FLOOR * sum(float(g.double().square().sum())
                                   for _, g in flatten(grads)) ** 0.5


@pytest.mark.parametrize("name", ["olmo_1b", "granite_20b", "whisper_small",
                                  "recurrentgemma_2b", "rwkv6_3b"])
def test_a_gradient_leaf_times_1_1_fails(name):
    """Every leaf but those whose gradient is 0 in exact arithmetic (held
    to the floor, where 1.1 x rounding stays rounding): the RG-LRU's gate
    leaves too, whose gradients are ~1e-7 of the whole at tiny widths."""
    cfg, _, _, card, cpu = _sides(name)
    leaves = flatten(card["grads"])
    zero = cs.zero_gradient_leaves(cfg)
    for i, (path, g) in enumerate(leaves):
        if "/".join(path) in zero:
            continue
        bad = [t * 1.1 if j == i else t for j, (_, t) in enumerate(leaves)]
        with pytest.raises(cs.SmokeFailure, match="gradient leaves"):
            cs.compare_reference(
                cfg, dict(card, grads=unflatten(card["grads"], bad)), cpu,
                _no_logits)
    assert zero == ({"enc_layers/attn/bk", "layers/xattn/bq",
                     "layers/xattn/bk", "layers/xattn/bv"}
                    if cfg.is_encdec else set())


def test_whisper_leaves_at_the_floor_are_held_to_it():
    """The cross-attention q/k/v biases (0: the loss does not reach them)
    and the encoder's key bias (0 in exact arithmetic, rounding in fp32):
    rounding-sized differences pass, a 1e-5 entry does not."""
    cfg, _, _, card, cpu = _sides("whisper_small")
    floor = cs.REF_GRAD_FLOOR * sum(float(g.double().square().sum())
                                    for _, g in flatten(cpu["grads"])) ** 0.5
    rec = cs.compare_reference(cfg, card, cpu, _no_logits)
    assert rec["grad_floor"] == pytest.approx(floor, rel=1e-6)
    assert set(rec["floor_leaves"]) == cs.zero_gradient_leaves(cfg)
    for path in (("enc_layers", "attn", "bk"), ("layers", "xattn", "bq")):
        leaf = card["grads"][path[0]][path[1]][path[2]]
        for size, fails in ((0.5 * floor / leaf.numel() ** 0.5, False),
                            (1e-5, True)):
            bad = tree_map(lambda t: t, card["grads"])
            bad[path[0]][path[1]][path[2]] = leaf + size
            if fails:
                with pytest.raises(cs.SmokeFailure, match="gradient leaves"):
                    cs.compare_reference(cfg, dict(card, grads=bad), cpu,
                                         _no_logits)
            else:
                cs.compare_reference(cfg, dict(card, grads=bad), cpu,
                                     _no_logits)


@pytest.mark.parametrize("name", ["olmo_1b", "command_r_plus_104b",
                                  "llava_next_mistral_7b", "phi35_moe_42b"])
def test_a_logit_moved_by_1e_2_fails(name):
    cfg, _, _, card, cpu = _sides(name)
    moved = card["logits"].clone()
    moved[0, 7] += 1e-2
    with pytest.raises(cs.SmokeFailure, match="logits"):
        cs.compare_reference(cfg, dict(card, logits=moved), cpu, _no_logits)


def test_a_loss_off_by_more_than_its_limit_fails():
    cfg, _, _, card, cpu = _sides("deepseek_coder_33b")
    loss = cpu["loss"] * (1 + 3 * cs.REF_LOSS_RTOL)
    with pytest.raises(cs.SmokeFailure, match="loss"):
        cs.compare_reference(cfg, dict(card, loss=loss), cpu, _no_logits)


def _flipped(routes, token, calls=None):
    """``routes`` with ``token``'s last choice swapped for the expert ranked
    just below its top k (by the record's own probabilities), in ``calls``
    (default: every call)."""
    out = []
    for c, r in enumerate(routes):
        r = dict(r)
        if calls is None or c in calls:
            e = r["experts"].clone().reshape(-1, r["experts"].shape[-1])
            p = r["probs"].reshape(-1, r["probs"].shape[-1])
            k = e.shape[-1]
            e[token, k - 1] = torch.argsort(p[token], descending=True,
                                            stable=True)[k]
            r["experts"] = e.reshape(r["experts"].shape)
        out.append(r)
    return out


def _tied(routes, token, gap):
    """``routes`` with the CPU's probabilities at ``token`` set so that its
    (k+1)-th expert trails its k-th by ``gap``."""
    out = []
    for r in routes:
        r = dict(r)
        p = r["probs"].clone().reshape(-1, r["probs"].shape[-1])
        k = r["experts"].shape[-1]
        order = torch.argsort(p[token], descending=True, stable=True)
        p[token, order[k]] = p[token, order[k - 1]] - gap
        r["probs"] = p.reshape(r["probs"].shape)
        out.append(r)
    return out


def _gap(routes, token):
    r = routes[0]
    p = r["probs"].reshape(-1, r["probs"].shape[-1])[token]
    k = r["experts"].shape[-1]
    top = p.sort(descending=True).values
    return float(top[k - 1] - top[k])


@pytest.mark.parametrize("name", MOE)
def test_a_flipped_route_above_the_gap_fails(name):
    cfg, _, _, card, cpu = _sides(name)
    token = 5
    assert _gap(cpu["routes"], token) > cs.ROUTE_TIE_GAP
    # in one call only: the prefill's
    flipped = dict(card, routes=_flipped(card["routes"], token, calls={0}))
    with pytest.raises(cs.SmokeFailure, match="beyond a near-tie"):
        cs.compare_reference(cfg, flipped, cpu, _no_logits)


@pytest.mark.parametrize("name", MOE)
def test_a_kept_pair_dropped_without_a_route_difference_fails(name):
    cfg, _, _, card, cpu = _sides(name)
    routes = [dict(r) for r in card["routes"]]
    keep = routes[1]["keep"].clone()
    g, t = (int(x) for x in keep.all(-1).nonzero()[0])
    keep[g, t, 0] = False
    routes[1]["keep"] = keep
    with pytest.raises(cs.SmokeFailure, match="beyond a near-tie"):
        cs.compare_reference(cfg, dict(card, routes=routes), cpu, _no_logits)


@pytest.mark.parametrize("name", MOE)
def test_a_near_tie_is_reported_and_held_to_the_agreed_logits(name, capsys):
    cfg, params, batch, card, cpu = _sides(name)
    token = 5
    tied = dict(cpu, routes=_tied(cpu["routes"], token, 1e-6))
    card_t = dict(card, routes=_flipped(card["routes"], token))
    rec = cs.compare_reference(cfg, card_t, tied, _no_logits)
    assert [(c, t) for c, t, _ in rec["near_ties"]] == [
        (c, token) for c in range(len(card["routes"]))]
    assert all(gap <= cs.ROUTE_TIE_GAP for _, _, gap in rec["near_ties"])
    # the last token agreed: its logits were held, not the loss or grads
    assert rec["logits_pos"] == TOKENS - 1 and "loss_err" not in rec
    assert "near-tie" in capsys.readouterr().out
    # a near-tie at the last token: the logits of the one before it
    last = TOKENS - 1
    asked = []

    def logits_at(pos):
        asked.append(pos)
        return (cs.reference_logits(params, cfg, batch, pos)[0],
                cs.reference_logits(params, cfg, batch, pos)[0])

    rec = cs.compare_reference(
        cfg, dict(card, routes=_flipped(card["routes"], last)),
        dict(cpu, routes=_tied(cpu["routes"], last, 1e-6)), logits_at)
    assert asked == [last - 1] and rec["logits_pos"] == last - 1
    assert rec["logits_err"] == 0.0


def test_the_tokens_are_cut_only_where_the_host_is_short(monkeypatch):
    cfg = cs.reference_configs()["command_r_plus_104b"]
    leaf = cfg.vocab_size * cfg.d_model * 4
    n = sum(t.numel() * 4 for _, t in flatten(lm.abstract_params(cfg)))
    need = {t: cs._host_need(cfg, t, n, leaf)
            for t in (cs.REF_TOKENS, cs.REF_MIN_TOKENS)}
    assert need[cs.REF_MIN_TOKENS] < need[cs.REF_TOKENS]
    for avail, want in ((need[cs.REF_TOKENS], cs.REF_TOKENS),
                        (need[cs.REF_TOKENS] - 1, cs.REF_MIN_TOKENS),
                        (need[cs.REF_MIN_TOKENS], cs.REF_MIN_TOKENS)):
        monkeypatch.setattr(cs, "_meminfo", lambda key, a=avail: a)
        assert cs.reference_tokens(cfg, n, leaf) == want
    monkeypatch.setattr(cs, "_meminfo",
                        lambda key: need[cs.REF_MIN_TOKENS] - 1)
    with pytest.raises(cs.SmokeFailure, match="cannot hold"):
        cs.reference_tokens(cfg, n, leaf)
