"""The port's observability stack: ``tests/test_obs.py``'s tracer, recorder,
chrome, metrics, validator and profile cases on the port; each package's
validator reading the other's dumps; the port's coordinator giving JAX's
sequence of trace records under the same four-fault trace; a traced run
bit-identical to an untraced one; both launchers' ``--trace-dir``; and
``capture_cost`` (exact on a product, within ``tests/test_analysis.py``'s
bound of ``cell_flops`` on a tiny forward).
"""
import collections
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread a worker is faster than 8 contending ones under
# the suite's parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import chaos as jchaos  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.distributed.steps import make_train_step as jmake  # noqa: E402
from repro.ft import CheckpointStore as JStore  # noqa: E402
from repro.ft import DynamicInterval as JInterval  # noqa: E402
from repro.ft import TrainingCoordinator as JCoordinator  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.obs import validate as jvalidate  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.analysis import flops as F  # noqa: E402
from repro_torch.chaos import (CKPT_CORRUPT, HOST_CRASH,  # noqa: E402
                               NAN_POISON, SLOWDOWN, ChaosEngine, FaultEvent,
                               FaultTrace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.distributed.steps import make_train_step  # noqa: E402
from repro_torch.ft import (CheckpointStore, DynamicInterval,  # noqa: E402
                            TrainingCoordinator)
from repro_torch.ft.crosspod import PodGradientExchange  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.shapes import Shape  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import (NULL_TRACER, FlightRecorder,  # noqa: E402
                             MetricsRegistry, Tracer, load_jsonl,
                             profile_jit, setup, to_chrome)
from repro_torch.obs.validate import (validate_chrome,  # noqa: E402
                                      validate_dir, validate_events)
from repro_torch.obs import trace as otrace  # noqa: E402
from repro_torch.obs import validate as tvalidate  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ------------------------------------------------------------- tracer ----

def test_null_tracer_is_shared_noop():
    assert not NULL_TRACER.enabled
    s1 = NULL_TRACER.span("x", step=1)
    s2 = NULL_TRACER.span("y")
    assert s1 is s2                       # one cached null object, no alloc
    with s1 as sp:
        assert sp.set(a=1) is sp
    NULL_TRACER.event("e")
    NULL_TRACER.fault("host_crash", step=3)
    NULL_TRACER.recovery("host_crash")
    # a tracer without a recorder is disabled even when asked to enable
    assert not Tracer(None, enabled=True).enabled


def test_span_nesting_parent_ids_and_error_attr():
    rec = FlightRecorder(64, clock=FakeClock())
    tr = Tracer(rec, clock=FakeClock())
    with tr.span("outer", step=1) as outer:
        with tr.span("inner"):
            tr.event("tick", n=2)
        outer.set(result="ok")
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    events = rec.snapshot()
    by_name = {e["name"]: e for e in events}
    assert by_name["tick"]["parent_id"] == by_name["inner"]["span_id"]
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["outer"]["parent_id"] is None
    assert by_name["outer"]["attrs"] == {"step": 1, "result": "ok"}
    assert by_name["boom"]["attrs"]["error"] == "RuntimeError"
    names = [e["name"] for e in events]
    assert names.index("inner") < names.index("outer")
    assert validate_events(events) == []


def test_complete_bypasses_stack():
    rec = FlightRecorder(16, clock=FakeClock())
    tr = Tracer(rec, clock=FakeClock())
    with tr.span("live"):
        tr.complete("offthread", 1.0, 5.0, track="ckpt-io", mode="async")
    off = [e for e in rec.snapshot() if e["name"] == "offthread"][0]
    assert off["parent_id"] is None and off["track"] == "ckpt-io"
    assert off["t0"] == 1.0 and off["t1"] == 5.0


# ----------------------------------------------------- recorder / ring ----

def test_ring_evicts_oldest_first():
    rec = FlightRecorder(4, clock=FakeClock())
    tr = Tracer(rec, clock=FakeClock())
    for i in range(10):
        tr.event(f"e{i}")
    assert len(rec) == 4
    assert [e["name"] for e in rec.snapshot()] == ["e6", "e7", "e8", "e9"]


def test_dump_on_fault_labels_cap_and_counters(tmp_path):
    clock = FakeClock()
    rec = FlightRecorder(32, out_dir=str(tmp_path), dump_on_fault=True,
                         max_dumps=3, clock=clock)
    tr = Tracer(rec, clock=clock)
    tr.fault("host_crash", step=1)
    tr.recovery("host_crash", restored_step=0)
    tr.fault("nan poison/..", step=2)     # label must be sanitized
    tr.fault("disk_full", step=3)         # over the cap: counted, not dumped
    assert [p.rsplit("/", 1)[-1] for p in rec.dumps] == [
        "0000_fault_host_crash.jsonl", "0001_recovery_host_crash.jsonl",
        "0002_fault_nan_poison_...jsonl"]
    assert rec.faults_seen == collections.Counter(
        {"host_crash": 1, "nan poison/..": 1, "disk_full": 1})
    assert rec.recoveries_seen == collections.Counter({"host_crash": 1})
    final = rec.dump("run_end")
    assert final.endswith("0003_run_end.jsonl")
    assert [e["name"] for e in load_jsonl(final)] == [
        "fault.host_crash", "recover.host_crash", "fault.nan poison/..",
        "fault.disk_full"]
    problems, summary = validate_dir(str(tmp_path))
    assert problems == [] and summary["jsonl_files"] == 4


def test_window_filters_old_events():
    clock = FakeClock()
    rec = FlightRecorder(100, window_s=3.0, clock=clock)
    tr = Tracer(rec, clock=clock)
    for i in range(8):
        tr.event(f"e{i}")                 # event i lands at t = i + 1
    assert [e["name"] for e in rec.snapshot()] == ["e5", "e6", "e7"]


def test_chrome_conversion_schema():
    rec = FlightRecorder(16, clock=FakeClock())
    tr = Tracer(rec, clock=FakeClock())
    with tr.span("work", step=4, skip=None):
        tr.event("mark")
    doc = to_chrome(rec.snapshot())
    assert validate_chrome(doc) == []
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    marks = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert len(spans) == 1 and len(marks) == 1
    assert spans[0]["dur"] > 0
    assert "skip" not in spans[0]["args"]     # None attrs are elided


def test_validator_cli_and_bad_dumps(tmp_path, capsys):
    good = tmp_path / "good"
    ctx = setup(str(good), clock=FakeClock())
    with ctx.tracer.span("crosspod.heal", pods=[2]):
        ctx.tracer.event("crosspod.catchup", pod=2)
    assert ctx.finish() is not None
    assert tvalidate.main([str(good), "--require-span", "crosspod.heal",
                           "--list-spans"]) == 0
    assert "trace schema OK" in capsys.readouterr().out
    assert tvalidate.main([str(good), "--require-span", "nope"]) == 1
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "0000_x.jsonl").write_text(
        json.dumps({"type": "span", "name": "", "t0": 2.0, "t1": 1.0}) + "\n"
        + json.dumps({"type": "what"}) + "\n")
    (bad / "0000_x.trace.json").write_text(json.dumps(
        {"traceEvents": [{"name": "a", "ph": "Q", "ts": "x"}]}))
    problems, _ = validate_dir(str(bad))
    assert any("span missing" in p for p in problems)
    assert any("unknown record type" in p for p in problems)
    assert any("unexpected phase" in p for p in problems)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tvalidate.main([str(empty)]) == 1


# ------------------------------------------------------------ metrics ----

def test_counter_labels_and_value():
    reg = MetricsRegistry()
    c = reg.counter("drops_total", "drops", ("reason",))
    c.inc(reason="shed")
    c.inc(2.0, reason="hedge")
    assert c.value(reason="shed") == 1.0 and c.total() == 3.0
    assert reg.value("drops_total", reason="hedge") == 2.0
    assert reg.value("missing_metric") == 0.0
    with pytest.raises(ValueError):
        c.inc(wrong="label")
    assert reg.counter("drops_total", "drops", ("reason",)) is c
    with pytest.raises(ValueError):
        reg.gauge("drops_total")


def test_prometheus_escaping_and_exposition():
    reg = MetricsRegistry()
    c = reg.counter("odd_total", 'help with \\ and\nnewline', ("path",))
    c.inc(path='a"b\\c\nd')
    text = reg.to_prometheus()
    assert '# HELP odd_total help with \\\\ and\\nnewline' in text
    assert 'odd_total{path="a\\"b\\\\c\\nd"} 1.0' in text
    assert "# TYPE odd_total counter" in text


def test_histogram_exposition_cumulative(tmp_path):
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", ("op",),
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v, op="step")
    text = reg.to_prometheus()
    assert 'lat_seconds_bucket{op="step",le="0.1"} 1' in text
    assert 'lat_seconds_bucket{op="step",le="1.0"} 3' in text
    assert 'lat_seconds_bucket{op="step",le="+Inf"} 4' in text
    assert 'lat_seconds_count{op="step"} 4' in text
    assert h.sum(op="step") == pytest.approx(6.05)
    jpath, _ = reg.write(str(tmp_path))
    dumped = json.load(open(jpath))
    assert dumped["lat_seconds"]["series"]["op=step"]["count"] == 4


def test_serve_metrics_shim_maps_to_registry():
    reg = MetricsRegistry()
    m = ServeMetrics(registry=reg)
    m.shed += 1
    m.rejected_on_arrival += 2
    m.past_first_token_drops += 1
    m.failures += 1
    m.prefill_tokens += 64
    assert m.shed == 1 and m.rejected_on_arrival == 2
    assert reg.value("serve_drops_total", reason="shed") == 1.0
    assert reg.value("serve_drops_total",
                     reason="rejected_on_arrival") == 2.0
    assert reg.value("serve_drops_total", reason="past_first_token") == 1.0
    assert reg.value("serve_events_total", kind="worker_failure") == 1.0
    assert reg.value("serve_tokens_total", kind="prefill") == 64.0
    s = m.summary(10)
    assert s["shed"] == 1 and s["past_first_drops"] == 1


# ------------------------------------------------------------ profile ----

def test_profile_jit_records_first_call_then_steady_state():
    reg = MetricsRegistry()
    prof = profile_jit(lambda x: x * 2.0, name="double", registry=reg,
                       clock=FakeClock())
    x = torch.ones(4)
    for _ in range(4):
        prof(x)
    rep = prof.report()
    assert rep["compile_s"] is not None and rep["calls"] == 3
    assert reg.value("profile_compile_seconds", step="double") > 0
    assert reg.value("profile_step_seconds", step="double") == 3.0
    cost = prof.capture_cost(x)
    assert prof.stats.flops is not None and "flops" in cost
    assert cost["bytes accessed"] == 2 * 4 * 4    # x read, the double written
    assert prof.report()["achieved_flops_per_s"] is None   # 0 FLOPs


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (3, 5, 7)])
def test_capture_cost_exact_for_a_product(m, k, n):
    reg = MetricsRegistry()
    prof = profile_jit(lambda a, b: a @ b, name="mm", registry=reg)
    x, w = torch.randn(m, k), torch.randn(k, n)
    prof(x, w)
    prof(x, w)
    cost = prof.capture_cost(x, w)
    assert cost["flops"] == 2 * m * k * n
    assert cost["bytes accessed"] == 4 * (m * k + k * n + m * n)
    assert cost["kernels"] == {}       # on the CPU no kernel launches
    assert reg.value("profile_step_flops", step="mm") == 2 * m * k * n
    rep = prof.report()
    assert rep["calls"] == 1 and rep["achieved_flops_per_s"] > 0


def _last_logits(params, cfg, tokens):
    """The port's forward (its layer loop is already unrolled): last-token
    logits, prefill semantics."""
    dtype = torch.float32
    x = params["embed"].to(dtype)[tokens.long()]
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    h, _ = lm.backbone(params, cfg, x, pos)
    return h[:, -1] @ lm.output_weights(params, cfg, dtype)


def test_capture_cost_within_the_analytic_bound_of_cell_flops():
    """``tests/test_analysis.py``'s bound (rel 0.35) between the analytic
    ``cell_flops`` and the counted FLOPs of the tiny forward."""
    cfg = dataclasses.replace(
        get_config("olmo_1b", tiny=True), n_layers=3, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=2048,
        compute_dtype="float32", remat=False)
    b, s = 2, 256
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    prof = profile_jit(lambda p, t: _last_logits(p, cfg, t), name="fwd")
    with torch.no_grad():
        counted = prof.capture_cost(params, tokens)["flops"]
    analytic = F.cell_flops(cfg, Shape("prefill_test", "prefill", s, b)).flops
    assert analytic == pytest.approx(counted, rel=0.35), \
        f"analytic {analytic:.3g} vs counted {counted:.3g}"


# ----------------------------------------- chaos run -> dumps on fault ----

FOUR_FAULTS = [(3, SLOWDOWN, (0,), 2), (6, NAN_POISON, (), 0),
               (9, CKPT_CORRUPT, (0,), 0), (11, HOST_CRASH, (0,), 2)]


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module")
def train_setup():
    jcfg = _fp32(jax_get_config("olmo-1b", tiny=True))
    tcfg = _fp32(get_config("olmo-1b", tiny=True))
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tstep = make_train_step(tcfg, q_chunk=16, xent_chunk=16)
    return jcfg, tcfg, jparams, np_params, tstep


def run_chaos_coordinator(train_setup, ckpt_dir, *, tracer=None,
                          registry=None, n_steps=18):
    _, tcfg, _, np_params, tstep = train_setup
    trace = FaultTrace(events=[FaultEvent(step=s, kind=k, targets=t,
                                          duration=d)
                               for s, k, t, d in FOUR_FAULTS])
    params = lm.params_from_jax(np_params, tcfg, device="cpu")
    coord = TrainingCoordinator(
        train_step=tstep, params=params, opt_state=adamw_init(params),
        pipeline=SyntheticTokenPipeline(DataConfig(4, 32), tcfg),
        store=CheckpointStore(ckpt_dir, tracer=tracer),
        interval=DynamicInterval(gamma_s=1.0, lam_min=2.0, lam_max=2.0),
        chaos=ChaosEngine(trace, tracer=tracer), tracer=tracer,
        registry=registry)
    return coord, coord.run(n_steps)


def test_coordinator_dumps_on_four_fault_classes(train_setup, tmp_path):
    ctx = setup(str(tmp_path / "trace"), dump_on_fault=True)
    _, report = run_chaos_coordinator(train_setup, str(tmp_path / "ckpt"),
                                      tracer=ctx.tracer,
                                      registry=ctx.registry)
    assert report.steps_completed == 18
    assert ctx.finish() is not None
    assert set(ctx.recorder.faults_seen) >= {
        SLOWDOWN, NAN_POISON, CKPT_CORRUPT, HOST_CRASH}
    dump_names = [p.rsplit("/", 1)[-1] for p in ctx.recorder.dumps]
    for kind in (SLOWDOWN, NAN_POISON, CKPT_CORRUPT, HOST_CRASH):
        assert any(f"fault_{kind}" in n for n in dump_names), kind
    problems, _ = validate_dir(
        str(tmp_path / "trace"),
        require_spans=[f"fault.{HOST_CRASH}", f"recover.{HOST_CRASH}",
                       f"recover.{NAN_POISON}", "ckpt.save",
                       "ckpt.restore"])
    assert problems == []
    assert ctx.registry.value("train_events_total", kind="failure") >= 1
    assert ctx.registry.value("train_events_total",
                              kind="nan_rollback") >= 1
    assert ctx.registry.value("train_checkpoints_total",
                              mode="sync") + ctx.registry.value(
        "train_checkpoints_total", mode="async") == report.checkpoints


def test_traced_run_is_bit_identical_to_untraced(train_setup, tmp_path):
    plain_coord, plain = run_chaos_coordinator(train_setup,
                                               str(tmp_path / "a"))
    ctx = setup(str(tmp_path / "trace"), dump_on_fault=True)
    traced_coord, traced = run_chaos_coordinator(
        train_setup, str(tmp_path / "b"), tracer=ctx.tracer,
        registry=ctx.registry)
    assert plain.losses == traced.losses
    assert plain.failures == traced.failures
    assert plain.nan_rollbacks == traced.nan_rollbacks
    assert plain.checkpoints == traced.checkpoints
    for (name, x), (_, y) in zip(flatten(plain_coord.params),
                                 flatten(traced_coord.params)):
        assert x.numpy().tobytes() == y.numpy().tobytes(), name


def _records(trace_dir):
    """(type, name) of the final dump's records: the main track in order,
    the async checkpoint writer's (another thread) as a sorted list."""
    final = sorted(p for p in os.listdir(trace_dir)
                   if p.endswith("_run_end.jsonl"))[-1]
    recs = load_jsonl(os.path.join(trace_dir, final))
    main = [(r["type"], r["name"]) for r in recs if r["track"] != "ckpt-io"]
    io = sorted((r["type"], r["name"]) for r in recs
                if r["track"] == "ckpt-io")
    return main, io


def test_coordinator_records_match_jax_and_validators_cross_read(
        train_setup, tmp_path):
    """The four-fault trace on both packages' coordinators: the same
    sequence of (type, name) records in their final dumps, and each
    package's validator accepts the other's dumps."""
    jcfg, _, jparams, _, _ = train_setup
    tdir, jdir = str(tmp_path / "port_trace"), str(tmp_path / "jax_trace")
    ctx = setup(tdir, dump_on_fault=True)
    run_chaos_coordinator(train_setup, str(tmp_path / "port"),
                          tracer=ctx.tracer, registry=ctx.registry)
    ctx.finish()
    jctx = jobs.setup(jdir, dump_on_fault=True)
    jtrace = jchaos.FaultTrace(events=[
        jchaos.FaultEvent(step=s, kind=k, targets=t, duration=d)
        for s, k, t, d in FOUR_FAULTS])
    JCoordinator(
        train_step=jax.jit(jmake(jcfg, q_chunk=16, xent_chunk=16)),
        params=jparams, opt_state=jadamw_init(jparams),
        pipeline=JPipeline(JDataConfig(4, 32), jcfg),
        store=JStore(str(tmp_path / "jax"), tracer=jctx.tracer),
        interval=JInterval(gamma_s=1.0, lam_min=2.0, lam_max=2.0),
        chaos=jchaos.ChaosEngine(jtrace, tracer=jctx.tracer),
        tracer=jctx.tracer, registry=jctx.registry).run(18)
    jctx.finish()
    assert _records(tdir) == _records(jdir)
    assert (sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)))
    required = [f"fault.{HOST_CRASH}", f"recover.{HOST_CRASH}",
                f"recover.{NAN_POISON}", "ckpt.save", "ckpt.restore"]
    for validate_dir_ in (validate_dir, jvalidate.validate_dir):
        for d in (tdir, jdir):
            problems, summary = validate_dir_(d, require_spans=required)
            assert problems == [], (d, problems)
            assert summary["jsonl_files"] >= 5


# ---------------------------------------------------- profiler ranges ----

def _ranges(prof, names):
    """(name, start_ns, end_ns) of the profile's host events named in
    ``names``, in start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda r: r[1])


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def test_range_is_the_shared_null_span_without_a_profiler(monkeypatch):
    import torch.autograd.profiler as tprof

    def refuse(*a, **k):
        raise AssertionError("range() called into the profiler")

    monkeypatch.setattr(tprof, "record_function", refuse)
    null = NULL_TRACER.span("x")
    for name in ("train.step", "moe.route", "anything"):
        r = otrace.range(name)
        assert r is null
        with r as sp:
            assert sp is null


def test_the_profiler_flag_that_ranges_read_exists():
    # a torch without this attribute would silently drop every range
    import torch.autograd.profiler as tprof
    assert tprof._is_profiler_enabled is False
    with _cpu_profile():
        assert tprof._is_profiler_enabled is True
    assert tprof._is_profiler_enabled is False


def test_ranges_nest_and_tracer_spans_mirror_under_the_profiler():
    rec = FlightRecorder(64)
    tracer = Tracer(rec, clock=FakeClock())
    with _cpu_profile() as prof:
        with otrace.range("outer"):
            with otrace.range("inner"):
                torch.ones(4).sum()
            with tracer.span("ckpt.save", step=1):
                torch.ones(4).sum()
    got = _ranges(prof, {"outer", "inner", "ckpt.save"})
    assert [g[0] for g in got] == ["outer", "inner", "ckpt.save"]
    (_, oa, ob), (_, ia, ib), (_, ca, cb) = got
    assert oa <= ia < ib <= ca < cb <= ob
    # the recorder holds the tracer's span and none of the ranges
    assert [(r["type"], r["name"]) for r in rec.snapshot()] == [
        ("span", "ckpt.save")]


#: the ranges of one train step (``train.h2d`` holds the batch's copy)
STEP_RANGES = ("train.step", "train.h2d", "train.forward", "train.backward",
               "train.optimizer", "lm.embed", "lm.xent", "layer.attn")
MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_one_train_step_marks_every_range(arch):
    cfg = get_config(arch, tiny=True)
    assert cfg.remat
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, q_chunk=16, xent_chunk=16)
    batch = SyntheticTokenPipeline(DataConfig(2, 32), cfg).batch_at(0)
    names = set(STEP_RANGES + MOE_RANGES) | {"layer.mlp", "layer.moe"}
    with _cpu_profile() as prof:
        step(params, adamw_init(params), batch)
    got = _ranges(prof, names)
    count = collections.Counter(g[0] for g in got)
    n, chunks = cfg.n_layers, 2          # 32 positions in chunks of 16
    ffn = "layer.moe" if cfg.is_moe else "layer.mlp"
    # every remat unit (a layer, a loss chunk) runs again in the backward
    want = {"train.step": 1, "train.h2d": 1, "train.forward": 1,
            "train.backward": 1, "train.optimizer": 1, "lm.embed": 1,
            "lm.xent": 2 * chunks, "layer.attn": 2 * n, ffn: 2 * n}
    if cfg.is_moe:
        # the routing and, after the combine, the load-balancing loss
        want.update({"moe.route": 4 * n, "moe.dispatch": 2 * n,
                     "moe.experts": 2 * n, "moe.combine": 2 * n})
    assert dict(count) == want
    span = {g[0]: g[1:] for g in got if g[0].startswith("train.")}
    (sa, sb) = span["train.step"]
    order = ["train.h2d", "train.forward", "train.backward",
             "train.optimizer"]
    for a, b in zip(order, order[1:]):
        assert span[a][1] <= span[b][0]
    assert sa <= span["train.h2d"][0] and span["train.optimizer"][1] <= sb
    fa, fb = span["train.forward"]
    ba, bb = span["train.backward"]
    for name, a, b in got:
        if name.startswith(("layer.", "moe.", "lm.xent")):
            # the first pass in the forward, the recompute in the backward
            assert fa <= a < b <= fb or ba <= a < b <= bb, name
    in_fwd = collections.Counter(name for name, a, _ in got if fa <= a <= fb)
    assert in_fwd[ffn] == n and in_fwd["lm.xent"] == chunks


def test_recorder_records_are_the_same_under_a_profiler(train_setup,
                                                        tmp_path):
    """Ranges never reach the flight recorder: the four-fault run under a
    profiler gives the records of the same run without one."""
    dirs = []
    for i, profiled in enumerate((False, True)):
        d = str(tmp_path / f"trace{i}")
        ctx = setup(d, dump_on_fault=True)
        if profiled:
            with _cpu_profile() as prof:
                run_chaos_coordinator(train_setup, str(tmp_path / f"c{i}"),
                                      tracer=ctx.tracer,
                                      registry=ctx.registry)
            mirrored = {g[0] for g in _ranges(prof, {"ckpt.save",
                                                     "train.step"})}
            assert mirrored == {"ckpt.save", "train.step"}
        else:
            run_chaos_coordinator(train_setup, str(tmp_path / f"c{i}"),
                                  tracer=ctx.tracer, registry=ctx.registry)
        ctx.finish()
        dirs.append(d)
    assert _records(dirs[0]) == _records(dirs[1])
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))


# ------------------------------------------------- fingerprint gating ----

def test_exchange_round_skips_fingerprint_on_request():
    ex = PodGradientExchange(2)
    grads = {"w": torch.ones(8)}
    with_fp = ex.round([grads, grads])
    assert with_fp.fingerprint
    without = ex.round([grads, grads], with_fingerprint=False)
    assert without.fingerprint is None


# ------------------------------------------------------- the launchers ----

def test_train_launcher_trace_dir_writes_dumps_metrics_and_profile(
        tmp_path):
    tdir = tmp_path / "trace"
    args = launch_train.build_parser().parse_args([
        "--tiny", "--device", "cpu", "--steps", "8", "--global-batch", "2",
        "--seq-len", "32", "--chaos", "unstable", "--chaos-seed", "3",
        "--chaos-assert", "--trace-dir", str(tdir), "--trace-dump-on-fault",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    cfg = get_config("olmo-1b", tiny=True)
    built = launch_train.build(cfg, args)
    coord = built["coord"]
    profiled, calls = coord.train_step, [0]
    assert profiled is built["profiled"]

    def counted(*a):
        calls[0] += 1
        return profiled(*a)

    coord.train_step = counted
    ctx = launch_train.run(cfg, args, built)["obs"]
    names = set(os.listdir(tdir))
    assert {"metrics.json", "metrics.prom", "profile.json"} <= names
    assert any(n.endswith("_run_end.jsonl") for n in names)
    prof = json.load(open(tdir / "profile.json"))
    assert len(prof) == 1 and prof[0]["name"] == "train_step"
    # every train-step call went through the wrapper, the first as its
    # first call
    assert calls[0] > args.steps and prof[0]["calls"] == calls[0] - 1
    assert prof[0]["flops"] > 0 and prof[0]["bytes_accessed"] > 0
    metrics = json.load(open(tdir / "metrics.json"))
    assert "train_events_total" in metrics and "profile_step_seconds" in \
        metrics
    problems, _ = validate_dir(
        str(tdir), require_spans=[f"recover.{HOST_CRASH}", "ckpt.restore",
                                  "profile.compile"])
    assert problems == [], problems
    assert ctx.recorder.recoveries_seen[HOST_CRASH] >= 1
    # the CLI end to end: without --trace-dir nothing is written there
    out = launch_train.main([
        "--tiny", "--device", "cpu", "--steps", "3", "--global-batch", "2",
        "--seq-len", "32"])
    assert out["profiled"] is None and not out["obs"].enabled


def test_train_launcher_profile_steps_writes_the_device_trace(tmp_path):
    tdir = tmp_path / "trace"
    out = launch_train.main([
        "--arch", "granite-moe-1b-a400m", "--tiny", "--device", "cpu",
        "--steps", "5", "--global-batch", "2", "--seq-len", "32",
        "--trace-dir", str(tdir), "--profile-steps", "2:3"])
    window = out["window"]
    assert window.calls == 5 and window.written == str(
        tdir / "device_trace.json")
    events = json.load(open(tdir / "device_trace.json"))["traceEvents"]
    count = collections.Counter(e["name"] for e in events)
    # two steps in the window, each with its phases and its MoE stages
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        assert count[name] == 2, name
    assert count["moe.experts"] == 2 * 2 * 2
    with pytest.raises(SystemExit):
        launch_train.main(["--tiny", "--device", "cpu", "--steps", "2",
                           "--profile-steps", "1:2"])      # no --trace-dir
    with pytest.raises(SystemExit):
        launch_train.main(["--tiny", "--device", "cpu", "--steps", "2",
                           "--trace-dir", str(tmp_path / "t2"),
                           "--profile-steps", "3:1"])


def test_serve_launcher_trace_dir_writes_dumps_and_metrics(tmp_path):
    tdir = tmp_path / "trace"
    res = launch_serve.main([
        "--arch", "olmo-1b", "--tiny", "--device", "cpu", "--requests", "6",
        "--policy", "crch", "--env", "unstable", "--trace-dir", str(tdir),
        "--trace-dump-on-fault"])
    s = res["summary"]
    assert s["completed"] == 6 and s["failures"] > 0
    names = set(os.listdir(tdir))
    assert {"metrics.json", "metrics.prom"} <= names
    problems, _ = validate_dir(str(tdir), require_spans=[
        "serve.worker_failure", "serve.resume", "recover.host_crash",
        "serve.prefill", "serve.decode"])
    assert problems == [], problems
    metrics = json.load(open(tdir / "metrics.json"))
    assert "serve_tokens_total" in metrics
    # the traced run's tokens equal an untraced run's
    plain = launch_serve.main([
        "--arch", "olmo-1b", "--tiny", "--device", "cpu", "--requests", "6",
        "--policy", "crch", "--env", "unstable"])
    assert (plain["engine"].completed == res["engine"].completed)
