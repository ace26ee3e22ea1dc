"""An architecture's questions answered by its reference module: the
defaults keep the two cells' readings, a stand-in module that defines every
hook changes the leaves, the FLOPs and B2's work, ``load`` refuses a ``run``
key nobody knows, and a head width other than d/h runs end to end."""
import copy
import sys
import time

import pytest

from conftest import TINY, TINY_TRAFFIC
from port_bench import arch, flops, harness, peaks, spec, weights
from port_bench.model import load
from test_bench_arith import H100, run_of, synthetic_trace

BENCH = spec.benchmark()
STAND_IN = "arch_stand_in"

#: the readings of the parent's formulas (every layer causal and full-width
#: at d/h, every layer MoE where there are experts) on ``synthetic_trace``
FROZEN = {
    "olmo-1b": {"step_mfu": 24.728198208815368,
                "b2_fwd_roofline": 0.13903545231142567,
                "b2_bwd_roofline": 0.34758863077856433},
    "granite-moe-1b-a400m": {"step_mfu": 9.52156711986734,
                             "b2_fwd_roofline": 0.06951772615571283,
                             "b2_bwd_roofline": 0.17379431538928217},
}


@pytest.mark.parametrize("config", list(FROZEN))
@pytest.mark.parametrize("metric", ["step_mfu", "b2_fwd_roofline",
                                    "b2_bwd_roofline"])
def test_the_cells_readings_are_the_parents(config, metric):
    got = spec.reader(metric)(run_of(synthetic_trace(), config))
    assert got == pytest.approx(FROZEN[config][metric], rel=1e-12)


def test_the_cells_trees_and_moe_calls_are_the_defaults():
    olmo = load("olmo-1b", spec.config(BENCH, "olmo-1b"))
    granite = load("granite-moe-1b-a400m",
                   spec.config(BENCH, "granite-moe-1b-a400m"))
    for m in (olmo, granite):
        assert m.arch == {} and m.passed == ()
        assert m.head_dim == m.d_model // m.n_heads
        assert arch.leaf_specs(m) == weights.leaf_specs(m)
    assert (arch.moe_layers(olmo), arch.moe_layers(granite)) == (0, 24)
    empty = [p for p, s, _ in weights.leaf_specs(olmo) if s is None]
    assert empty == ["final_norm", "layers/ln1", "layers/ln2"]


def test_load_refuses_an_unknown_run_key():
    data = copy.deepcopy(spec.config(BENCH, "olmo-1b"))
    data["run"]["norm_epsilon"] = 1e-5
    with pytest.raises(ValueError, match="norm_epsilon"):
        load("olmo-1b", data)


def test_the_published_head_dim_is_read():
    data = dict(spec.config(BENCH, "olmo-1b"), head_dim=256)
    assert load("olmo-1b", data).head_dim == 256


def trinity_like(**run):
    """Trinity-Mini's published widths at four layers (three windowed, one
    full), on the stand-in reference."""
    return {
        "hidden_size": 2048, "intermediate_size": 6144,
        "num_hidden_layers": 4, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "vocab_size": 200192,
        "num_experts": 128, "num_experts_per_tok": 8,
        "moe_intermediate_size": 1024, "num_shared_experts": 1,
        "num_dense_layers": 2, "sliding_window": 2048,
        "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
        "tie_word_embeddings": False,
        "run": {"family": "moe", "reference": STAND_IN, **run},
    }


@pytest.fixture
def stand_in(monkeypatch):
    """The tests' own reference module, found by its name as a
    configuration's ``reference``."""
    mod = spec.module("tests", STAND_IN)
    monkeypatch.setitem(sys.modules, f"port_bench.reference.{STAND_IN}", mod)
    return mod


def test_the_stand_in_names_the_keys_and_the_tree(stand_in):
    m = load("trinity-like", trinity_like(window=2048))
    assert m.head_dim == 128 and m.n_experts == 128
    assert m.arch["moe_intermediate_size"] == 1024
    assert m.arch["layer_types"][3] == "full_attention"
    assert m.passed == ("window",)
    specs = arch.leaf_specs(m)
    assert specs == stand_in.leaf_specs(m) != weights.leaf_specs(m)
    assert ("moe/shared/w_down", (2, 1024, 2048), 1024) in specs
    assert arch.moe_layers(m) == 2


def test_the_stand_in_tree_is_drawn(stand_in):
    tiny = dict(trinity_like(), hidden_size=16, intermediate_size=32,
                num_attention_heads=2, num_key_value_heads=1, head_dim=16,
                vocab_size=64, num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=8)
    tree = weights.draw(load("tiny", tiny), 5, "cpu")
    assert tree["final_norm"] == {}
    assert tuple(tree["moe"]["shared"]["w_up"].shape) == (2, 16, 8)
    assert tuple(tree["layers"]["attn"]["wq"].shape) == (4, 16, 32)


def test_the_stand_in_sets_the_flops(stand_in):
    m = load("trinity-like", trinity_like())
    b, s = 1, 8192
    assert flops.train_model_flops(m, b, s) == \
        3 * stand_in.forward_flops(m, b, s) != 3 * flops.forward_flops(m, b, s)


def test_the_b2_work_of_three_windowed_and_one_full_layer(stand_in):
    """Worked by hand at one sequence of 8192 tokens: a windowed layer's
    head attends 2048 x 2049 / 2 + 6144 x 2048 = 14,681,088 pairs, a full
    layer's 8192 x 8193 / 2 = 33,558,528; the readers take the mean of the
    four layers' least times."""
    m = load("trinity-like", trinity_like())
    p = peaks.PEAKS[H100]
    h, kv, hd, s = 32, 4, 128, 8192
    io_f = 2 * (2 * h * s * hd + 2 * kv * s * hd) + 4 * h * s
    io_b = 2 * (4 * h * s * hd + 4 * kv * s * hd) + 4 * h * s
    least_f = [max(4 * h * n * hd / p["bfloat16"], io_f / p["bytes_s"])
               for n in (14_681_088,) * 3 + (33_558_528,)]
    least_b = [max(10 * h * n * hd / p["bfloat16"], io_b / p["bytes_s"])
               for n in (14_681_088,) * 3 + (33_558_528,)]
    run = run_of(synthetic_trace(), "olmo-1b")
    run.model, run.traffic = m, {"batch": 1, "seq_len": s}
    # synthetic_trace: one flash_fwd launch of 0.1 s; one backward call
    # (its delta launch) of 0.1 s over its kernels
    assert spec.reader("b2_fwd_roofline")(run) == \
        pytest.approx(100 * sum(least_f) / 4 / 0.1, rel=1e-12)
    assert spec.reader("b2_bwd_roofline")(run) == \
        pytest.approx(100 * sum(least_b) / 4 / 0.1, rel=1e-12)
    # the default would count four full causal layers
    full = (flops.attention_fwd_work(m, 1, s),
            flops.attention_bwd_work(m, 1, s))
    assert arch.attention_layers(m, 1, s)[3] == full
    assert arch.attention_layers(m, 1, s)[0] != full


def test_the_port_takes_run_keys_by_name_and_names_one_it_lacks(stand_in):
    from port_bench.drivers.train import program_config
    assert program_config(load("t", trinity_like(window=2048))).window == 2048
    with pytest.raises(ValueError, match="dense_first"):
        program_config(load("t", trinity_like(dense_first=True)))


def test_a_head_width_of_twice_d_over_h_runs_correct():
    cell = "olmo1b-train-8x2048"
    tiny = TINY[cell]
    wide = 2 * tiny["d_model"] // tiny["n_heads"]
    result, readings = harness.run_cell(
        BENCH, cell, 2**31 + 21, 0.5, False, t_start=time.perf_counter(),
        device="cpu", model_overrides={**tiny, "head_dim": wide,
                                       "compute_dtype": "float32"},
        traffic_overrides=TINY_TRAFFIC)
    assert result["correct"], readings
    m = load("olmo-1b", spec.config(BENCH, "olmo-1b"), **tiny, head_dim=wide)
    assert ("layers/attn/wq", (2, 64, 4 * wide), 64) in arch.leaf_specs(m)
