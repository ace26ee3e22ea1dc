"""The plain reference against the port's tiny presets on the CPU, and the
fp8 control failing where the program passes."""
import pytest

from conftest import TINY, TINY_TRAFFIC
from port_bench import judge, spec
from port_bench.model import load

BENCH = spec.benchmark()
CELLS = list(TINY)


def parts(cell, **over):
    w = spec.cell(BENCH, cell)
    m = load(w["config"], spec.config(BENCH, w["config"]),
             **{**TINY[cell], **over})
    traffic = dict(spec.traffic(w["traffic"]), **TINY_TRAFFIC)
    return m, traffic, spec.module("drivers", traffic["driver"])


def program(cell, seed, **over):
    m, traffic, driver = parts(cell, **over)
    system = driver.System(m, traffic, seed, "cpu")
    readings = system.setup_steps()
    system.close()
    return readings


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_program_computing_in_fp32(cell):
    # the port with fp32 compute and the reference: the same sums to
    # rounding, so every number under 1e-5
    prog = program(cell, 3, compute_dtype="float32")
    m, traffic, driver = parts(cell)
    rd = judge.compare(prog, driver.reference_readings(
        m, traffic, 3, "cpu", routes=prog["routes"]))
    for k in judge.NUMBERS:
        assert rd.get(k, 0.0) < 1e-5, (k, rd)


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_reads_far_above_the_bf16_program(cell):
    m, traffic, driver = parts(cell)
    prog = program(cell, 4)
    sound = judge.compare(prog, driver.reference_readings(
        m, traffic, 4, "cpu", routes=prog["routes"]))
    fp8 = driver.reference_readings(m, traffic, 4, "cpu", "fp8")
    control = judge.compare(fp8, driver.reference_readings(
        m, traffic, 4, "cpu", routes=fp8["routes"]))
    assert max(control[k] / max(sound[k], 1e-12) for k in judge.NUMBERS
               if k in sound) > 3, (sound, control)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_deterministic_from_the_seed(cell):
    a, b = program(cell, 5), program(cell, 5)
    assert {k: a[k] for k in a if k != "routes"} == \
        {k: b[k] for k in b if k != "routes"}
    assert program(cell, 6)["losses"] != a["losses"]
