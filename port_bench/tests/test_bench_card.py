"""On the card, at the cells' own sizes: a short run of each cell is
correct, with its end-to-end and per-layer metrics, and the fp8 control
fails the cell's limits.  ``python -m pytest -m cuda port_bench/tests``."""
import time

import pytest

from port_bench import harness, judge, spec
from port_bench.model import load

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_is_correct(card, cell, trace):
    result, readings = harness.run_cell(
        BENCH, cell, 2**31 + 77, 2.0, trace, t_start=time.perf_counter())
    assert result["correct"], readings
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, trace)}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails(card, cell):
    w = spec.cell(BENCH, cell)
    m = load(w["config"], spec.config(BENCH, w["config"]))
    traffic = spec.traffic(w["traffic"])
    driver = spec.module("drivers", traffic["driver"])
    ref = driver.reference_readings(m, traffic, 2**31 + 78, card)
    control = driver.reference_readings(m, traffic, 2**31 + 78, card, "fp8")
    correct, checks = judge.judge(judge.compare(control, ref),
                                  spec.limits(cell))
    assert not correct, checks
