"""The yardstick's arithmetic: model FLOPs, the rooflines, the union of
device intervals and the idle gaps."""
import pytest

from port_bench import flops, harness, peaks, spec, trace as tr
from port_bench.model import load

BENCH = spec.benchmark()
H100 = "NVIDIA H100 80GB HBM3"


def model(name):
    return load(name, spec.config(BENCH, name))


def test_olmo_model_flops_match_the_recorded_figure():
    # PERF.md section 5: 61.14 TFLOP a step at 4 x 2048 (run G)
    assert flops.train_model_flops(model("olmo-1b"), 4, 2048) / 1e12 == \
        pytest.approx(61.14, abs=0.005)


def test_granite_moe_model_flops_match_the_recorded_figure():
    # PERF.md section 5: 23.54 TFLOP a step at 4 x 2048 (run G)
    assert flops.train_model_flops(
        model("granite-moe-1b-a400m"), 4, 2048) / 1e12 == \
        pytest.approx(23.54, abs=0.005)


def test_attended_pairs():
    assert flops.attended_pairs(4, True) == 10
    assert flops.attended_pairs(4, False) == 16
    assert flops.attended_pairs(6, True, window=2) == 3 + 4 * 2


def test_union_and_gaps():
    busy, gaps = tr.union([(1, 3), (2, 4), (6, 7), (9, 12)], 0, 10)
    assert busy == 3 + 1 + 1
    assert gaps == [(0, 1), (4, 6), (7, 9)]


def synthetic_trace():
    device = [("flash_fwd_tc<128,2>", 0.10, 0.20),
              ("nvjet_tst_256x128", 0.20, 0.50),
              ("void at::native::vectorized_elementwise_kernel", 0.60, 0.80),
              ("flash_bwd_delta<bf16>", 0.80, 0.82),
              ("flash_bwd_dq_tc<128,2>", 0.82, 0.90),
              ("Memcpy HtoD (Pageable -> Device)", 0.95, 1.00),
              ("flash_fwd_tc<128,2>", 1.10, 1.30)]     # past the window
    host = [("pb.step", 0.0, 1.0), ("aten::mm", 0.50, 0.61),
            ("cudaStreamSynchronize", 0.89, 0.96)]
    return tr.reduce_events(device, host, (0.0, 1.0), 2, [0.3, 0.25])


def test_reduce_events_clips_groups_and_names_gaps():
    t = synthetic_trace()
    assert t.window_s == 1.0
    assert t.busy_s == pytest.approx(0.1 + 0.3 + 0.2 + 0.02 + 0.08 + 0.05)
    # the gaps: [0, 0.1) pb.step, [0.5, 0.6) aten::mm, [0.9, 0.95) sync
    assert t.gaps == pytest.approx({"pb.step": 0.1, "aten::mm": 0.1,
                                    "cudaStreamSynchronize": 0.05})
    assert sum(t.gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.count(lambda k: "flash_fwd" in k) == 1
    assert tr.group("nvjet_tst_256x128") == "library"
    assert tr.group("flash_bwd_dq_tc<128,2>") == "port"
    assert tr.group("Memcpy HtoD (Pageable -> Device)") == "copy"
    b = t.breakdown()
    assert b["device_ops"][0][0] == "nvjet_tst_256x128"
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(0.25)


def run_of(t, name="olmo-1b"):
    m = model(name)
    return harness.Run(model=m, traffic=spec.traffic("packed-8x2048"),
                       kind=H100, setup_s=1.0, window_s=2.0, steps=4,
                       tokens=4 * 16384, peak_bytes=int(5e10), trace=t)


def test_metric_readers_on_a_synthetic_trace():
    t = synthetic_trace()
    run = run_of(t)
    read = lambda n: spec.reader(n)(run)  # noqa: E731
    assert read("train_tokens_per_s") == 4 * 16384 / 2.0
    assert read("peak_mem_gb") == 50.0
    assert read("device_idle_share") == pytest.approx(25.0)
    assert read("enqueue_ms") == pytest.approx(275.0)
    assert read("gemm_ms") == pytest.approx(1e3 * 0.3 / 2)
    assert read("elementwise_ms") == pytest.approx(1e3 * 0.2 / 2)
    m, p = run.model, peaks.PEAKS[H100]
    fwd = peaks.least_seconds(*flops.attention_fwd_work(m, 8, 2048), p)
    assert read("b2_fwd_roofline") == pytest.approx(100 * fwd / 0.1)
    bwd = peaks.least_seconds(*flops.attention_bwd_work(m, 8, 2048), p)
    assert read("b2_bwd_roofline") == pytest.approx(100 * bwd / 0.1)
    mfu = flops.train_model_flops(m, 8, 2048) * 2 / 1.0 / 989e12
    assert read("step_mfu") == pytest.approx(100 * mfu)


def test_readers_say_nothing_without_a_trace_or_a_known_card():
    run = run_of(None)
    for name in ("enqueue_ms", "gemm_ms", "elementwise_ms", "step_mfu",
                 "b2_fwd_roofline", "b2_bwd_roofline", "device_idle_share"):
        assert spec.reader(name)(run) is None
    unknown = run_of(synthetic_trace())
    unknown.kind = "cpu"
    for name in ("step_mfu", "b2_fwd_roofline", "b2_bwd_roofline"):
        assert spec.reader(name)(unknown) is None


def test_olmo_attention_work():
    m = model("olmo-1b")
    f, nbytes = flops.attention_fwd_work(m, 8, 2048)
    assert f == 4 * 8 * 16 * (2048 * 2049 // 2) * 128
    assert nbytes == 2 * (4 * 8 * 16 * 2048 * 128) + 4 * 8 * 16 * 2048
