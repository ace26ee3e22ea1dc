"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a training
cell on one chip can have, and true without one.  The program computes in
fp32 here, so that a sound run reads rounding alone at this tiny size."""
import time

import pytest

from conftest import TINY, TINY_TRAFFIC
from port_bench import harness, spec

BENCH = spec.benchmark()
CELLS = list(TINY)


def run(cell):
    result, readings = harness.run_cell(
        BENCH, cell, 2**31 + 11, 0.5, False, t_start=time.perf_counter(),
        device="cpu", model_overrides={**TINY[cell],
                                       "compute_dtype": "float32"},
        traffic_overrides=TINY_TRAFFIC)
    return result, readings


def plant(monkeypatch, wrap):
    """Replace the launcher's train-step factory by ``wrap(real step)``."""
    from repro_torch.launch import train as launch
    real = launch.make_train_step
    monkeypatch.setattr(launch, "make_train_step",
                        lambda *a, **k: wrap(real(*a, **k)))


def unchanged_state(step):
    def broken(params, opt_state, batch):
        return (params, opt_state) + step(params, opt_state, batch)[2:]
    return broken


def half_batch(step):
    def broken(params, opt_state, batch):
        rows = len(batch["tokens"]) // 2
        return step(params, opt_state, {k: v[:rows] for k, v in
                                        batch.items()})
    return broken


def altered_loss(step):
    """The step's loss, its answer, altered by 1% where it is produced."""
    def broken(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {**metrics, "loss": metrics["loss"] * 1.01}
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, readings = run(cell)
    assert result["correct"], readings
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_loss])
def test_fault_is_caught(cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    result, readings = run(cell)
    assert not result["correct"], readings
