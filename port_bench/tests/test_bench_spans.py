"""The attribution of a traced window to the program's ranges
(:mod:`port_bench.spans`): synthetic event lists, and a real CPU profile of
the port's tiny MoE train step."""
import pytest

from port_bench import spans as sp, trace as tr
from port_bench.spans import RANGE, Device, Host


def rng(name, thread, a, b):
    return Host(name, thread, a, b, RANGE)


def launch(thread, t, corr, link=0):
    """A runtime launch call at ``t`` with correlation id ``corr``."""
    return Host("cudaLaunchKernel", thread, t, t + 0.01, corr=corr,
                link=link)


def kernel(a, b, corr, name="k"):
    return Device(name, a, b, corr=corr)


def test_a_launch_inside_nested_ranges_counts_toward_each():
    host = [rng("train.step", 1, 0.0, 10.0), rng("train.forward", 1, 1, 5),
            rng("layer.moe", 1, 2, 4), rng("moe.experts", 1, 2.5, 3.5),
            Host("aten::bmm", 1, 2.6, 3.0, corr=10, seq=7),
            launch(1, 2.7, 100, link=10)]
    got = sp.attribute([kernel(3.0, 3.2, 100)], host, (0.0, 10.0))
    for name in ("moe.experts", "layer.moe", "train.forward", "train.step"):
        assert got[name].device_s == pytest.approx(0.2), name
        assert got[name].launches == 1
    assert "moe.route" not in got and sp.OUTSIDE not in got
    # host seconds: inclusive, and self (less the child ranges)
    assert got["layer.moe"].host_s == pytest.approx(2.0)
    assert got["layer.moe"].self_s == pytest.approx(1.0)
    assert got["train.step"].self_s == pytest.approx(6.0)


def test_a_launch_without_its_runtime_call_follows_the_host_op_link():
    host = [rng("train.step", 1, 0.0, 10.0), rng("moe.route", 1, 2, 4),
            Host("aten::sort", 1, 2.5, 3.0, corr=10)]
    got = sp.attribute([Device("sort", 3.0, 3.5, corr=999, link=10)], host,
                       (0.0, 10.0))
    assert got["moe.route"].device_s == pytest.approx(0.5)


def test_innermost_wins_on_the_launching_thread_across_two_threads():
    # thread 1 waits in train.backward; thread 2 recomputes a layer
    host = [rng("train.step", 1, 0.0, 10.0), rng("train.backward", 1, 1, 9),
            rng("layer.moe", 2, 2, 5), rng("moe.route", 2, 2.5, 4.4),
            launch(2, 3.0, 1), launch(1, 3.1, 2), launch(2, 4.5, 3)]
    device = [kernel(3.5, 3.6, 1), kernel(3.6, 3.8, 2),
              kernel(4.6, 4.7, 3), kernel(6.0, 6.1, 9)]   # 9: no launcher
    got = sp.attribute(device, host, (0.0, 10.0))
    assert got["moe.route"].device_s == pytest.approx(0.1)
    assert got["layer.moe"].device_s == pytest.approx(0.2)
    assert got["train.backward"].device_s == pytest.approx(0.4)
    assert got["train.backward"].launches == 3
    assert got[sp.OUTSIDE].device_s == pytest.approx(0.1)
    # the gap [3.8, 4.6) has its middle in moe.route on thread 2, which
    # opened last: it is named there, and counts toward the phases too
    assert got["moe.route"].idle_s == pytest.approx(0.8)
    assert got["layer.moe"].idle_s == pytest.approx(0.8)


def test_a_backward_node_resolves_to_its_forward_range():
    node = sp.AUTOGRAD_NODE + "BmmBackward0"
    host = [rng("train.step", 1, 0.0, 10.0), rng("train.forward", 1, 0.5, 5),
            rng("moe.experts", 1, 1, 2),
            Host("aten::bmm", 1, 1.1, 1.5, corr=5, seq=7),
            rng("moe.combine", 1, 2, 3),
            Host("aten::mul", 1, 2.1, 2.2, corr=6, seq=8),
            rng("train.backward", 1, 5.5, 9.5),
            Host(node, 2, 6.0, 8.0, seq=7, fwd_thread=1),
            launch(2, 7.0, 50),
            # a node whose forward op is not in the trace stands for none
            Host(sp.AUTOGRAD_NODE + "AccumulateGrad", 2, 8.2, 8.4),
            launch(2, 8.3, 51)]
    device = [kernel(7.1, 7.4, 50), kernel(8.4, 8.5, 51)]
    got = sp.attribute(device, host, (0.0, 10.0))
    assert got["moe.experts"].device_s == pytest.approx(0.3)
    assert got["train.backward"].device_s == pytest.approx(0.4)
    # counted by time: the forward does not get its backward's work
    assert "train.forward" not in got or got["train.forward"].device_s == 0
    assert "moe.combine" not in got or got["moe.combine"].device_s == 0
    index = sp.Index(host)
    assert index.resolve(host[7]) is host[2]


def test_an_idle_gap_inside_train_step_and_one_outside():
    host = [rng("pb.step", 1, 0.0, 7.0), rng("train.step", 1, 0.2, 5.0),
            launch(1, 0.3, 1), launch(1, 0.4, 2)]
    device = [kernel(1.0, 2.0, 1), kernel(3.0, 4.0, 2)]
    got = sp.attribute(device, host, (0.0, 7.0))
    # gaps [0, 1) and [2, 3) have their middles in train.step; [4, 7) not
    assert got["train.step"].idle_s == pytest.approx(2.0)
    assert got[sp.OUTSIDE].idle_s == pytest.approx(3.0)
    assert "pb.step" not in got
    m = sp.step_metrics(got, steps=1)
    assert m["step_idle_ms"] == pytest.approx(2000.0)
    assert m["step_launches"] == 2
    assert m["forward_ms"] is None and m["moe_experts_ms"] is None


def test_the_idle_and_busy_totals_agree_with_reduce_events():
    """On the harness's own synthetic window (no program range), every
    device second and idle second falls outside, and they add up to
    ``reduce_events``' busy time and idle gaps; the program's metrics say
    nothing."""
    device = [("flash_fwd_tc<128,2>", 0.10, 0.20),
              ("nvjet_tst_256x128", 0.20, 0.50),
              ("void at::native::vectorized_elementwise_kernel", 0.60, 0.80),
              ("Memcpy HtoD (Pageable -> Device)", 0.95, 1.00),
              ("flash_fwd_tc<128,2>", 1.10, 1.30)]
    host = [("pb.step", 0.0, 1.0), ("aten::mm", 0.50, 0.61)]
    t = tr.reduce_events(device, host, (0.0, 1.0), 2, [0.3, 0.25])
    got = sp.attribute([Device(n, a, b) for n, a, b in device],
                       [Host(n, 1, a, b) for n, a, b in host], (0.0, 1.0))
    assert list(got) == [sp.OUTSIDE]
    assert got[sp.OUTSIDE].device_s == pytest.approx(t.busy_s)
    assert got[sp.OUTSIDE].idle_s == pytest.approx(sum(t.gaps.values()))
    assert all(v is None for v in sp.step_metrics(got, 2).values())


def test_every_node_under_moe_resolves_to_it_on_a_cpu_profile():
    """One train step of the port's tiny MoE preset under the CPU profiler:
    every autograd node whose forward op ran under a ``moe.*`` range (the
    innermost range open at that op, found here by brute force) resolves to
    that range."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    cfg = get_config("granite-moe-1b-a400m", tiny=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, q_chunk=16, xent_chunk=16)
    batch = SyntheticTokenPipeline(DataConfig(2, 32), cfg).batch_at(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            step(params, adamw_init(params), batch)
    device, host, window = sp.events_of(prof)
    assert window is not None and device == []
    ranges = [h for h in host if h.kind == RANGE]
    assert {"train.step", "moe.route", "moe.experts"} <= {
        h.name for h in ranges}
    index = sp.Index(host)
    ops = {}
    for h in sorted(host, key=lambda h: h.start):
        if h.seq >= 0 and h.kind != RANGE and \
                not h.name.startswith(sp.AUTOGRAD_NODE):
            ops.setdefault((h.thread, h.seq), h)
    seen = set()
    nodes = [h for h in host if h.name.startswith(sp.AUTOGRAD_NODE)]
    assert nodes
    for n in nodes:
        f = ops.get((n.fwd_thread, n.seq))
        if f is None:
            continue
        around = [r for r in ranges if r.thread == f.thread
                  and r.start <= f.start < r.end]
        inner = max(around, key=lambda r: r.start, default=None)
        if inner is not None and inner.name.startswith("moe."):
            assert index.resolve(n) is inner, (n.name, inner.name)
            seen.add(inner.name)
    assert seen == {"moe.route", "moe.dispatch", "moe.experts",
                    "moe.combine"}


class _Event:
    """A kineto event as :func:`trace.reduce` and :func:`spans.events_of`
    read one."""

    def __init__(self, name, a, b, *, cpu=True, kind="cpu_op", thread=1,
                 corr=0, link=0, seq=-1):
        self._v = (name, a, b, cpu, kind, thread, corr, link, seq)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1e9)

    def end_ns(self):
        return int(self._v[2] * 1e9)

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CPU if self._v[3] else DeviceType.CUDA

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[4] == "user_annotation"

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]

    def sequence_nr(self):
        return self._v[8]

    def fwd_thread_id(self):
        return 0


def synthetic_profile():
    """Two traced steps in the window [0, 20) (seconds): each step's
    forward launches a routing kernel of 0.5 s and an experts' kernel of 1,
    its backward one of 3, its optimizer one of 0.5.  The card idles in
    [0, 1), [2.5, 3.5) and [12.5, 13.5), whose middles lie in a step, and in
    [7, 11) and [17, 20), whose middles lie outside the steps (the first
    step's gap before its first kernel joins the gap between the steps)."""
    def ann(name, a, b):
        return _Event(name, a, b, kind="user_annotation")

    events = [ann(tr.WINDOW, 0.0, 20.0)]
    corr = 0
    for t0 in (0.0, 10.0):
        events += [ann("pb.step", t0, t0 + 10), ann("train.step", t0, t0 + 8),
                   ann("train.forward", t0, t0 + 3),
                   ann("layer.moe", t0, t0 + 3),
                   ann("moe.route", t0, t0 + 1),
                   ann("moe.experts", t0 + 1, t0 + 3),
                   ann("train.backward", t0 + 3, t0 + 6),
                   ann("train.optimizer", t0 + 6, t0 + 8)]
        # (launched at, kernel start, kernel end)
        for at, a, b in ((0.5, 1.0, 1.5), (1.5, 1.5, 2.5), (3.5, 3.5, 6.5),
                         (6.5, 6.5, 7.0)):
            corr += 1
            events += [_Event("cudaLaunchKernel", t0 + at, t0 + at + 0.01,
                              kind="cuda_runtime", corr=corr),
                       _Event("kern", t0 + a, t0 + b, cpu=False,
                              kind="kernel", corr=corr)]
    from types import SimpleNamespace
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def test_trace_spans_of_a_profile_feed_the_seven_readers():
    from port_bench import harness, spec
    t = tr.reduce(synthetic_profile(), 2, [0.1, 0.1])
    assert t.busy_s == pytest.approx(10.0) and t.window_s == 20.0
    assert t.spans["train.step"].launches == 8
    run = harness.Run(model=None, traffic={}, kind="cpu", setup_s=0.0,
                      window_s=20.0, steps=2, tokens=0, peak_bytes=0,
                      trace=t)
    want = {"forward_ms": 1500.0, "backward_ms": 3000.0,
            "optimizer_ms": 500.0, "moe_route_ms": 500.0,
            "moe_experts_ms": 1000.0, "step_idle_ms": 1500.0,
            "step_launches": 4}
    for name, value in want.items():
        assert spec.reader(name)(run) == pytest.approx(value), name
    b = t.breakdown()
    assert b["spans"][0] == ["train.step", pytest.approx(10.0)]
    assert dict(b["idle_spans"])[sp.OUTSIDE] == pytest.approx(7.0)
    # a window with no program range: the readers say nothing
    run.trace = tr.Trace(20.0, 10.0, {}, {}, 2, [0.1])
    assert all(spec.reader(n)(run) is None for n in want)
