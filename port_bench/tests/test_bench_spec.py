"""BENCHMARK.json against the contract's shape, and the harness finding
every part of a cell by name."""
import json
import re

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert 1 <= len(e[key]) <= 200, (e["name"], key)
                assert "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"step loop", "model and optimizer on the card",
                      "MoE layer", "kernels", "device"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    assert w["chips"] == 1
    cfg = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    assert spec.module("drivers", traffic["driver"]).System
    spec.module("reference", cfg["run"]["reference"])
    limits = spec.limits(cell)
    assert {"loss_gap", "update_gap"} <= set(limits)
    for trace in (False, True):
        for m in spec.metrics_of(BENCH, cell, trace):
            assert callable(spec.reader(m["name"]))


def test_configs_hold_published_widths():
    for c in BENCH["configs"]:
        data = spec.config(BENCH, c["name"])
        widths = {"hidden_size", "intermediate_size", "num_attention_heads",
                  "num_key_value_heads", "num_experts_per_tok"}
        assert not widths & set(c["reduced"])
        for key in c["reduced"]:
            assert key in data


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.module("metrics", "no_such_metric")
