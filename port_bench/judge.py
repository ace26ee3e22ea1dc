"""The comparison that decides ``correct`` for a training cell.

The program and the reference each give (:mod:`port_bench.drivers.train`):
the loss of each set-up step, each leaf's norm of the first clipped
gradient, and each leaf's norm of the parameters' change over the set-up
steps.  Three numbers are compared, each with the limit of the cell's
``limits/<cell>.json``:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the two gradient norms, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero);
- ``update_gap``: the same of the parameters' change, over the leaves whose
  reference gradient is at least :data:`MOVED` of the median leaf's (a leaf
  whose gradient is nought to rounding moves under Adam by round-off
  alone);
- ``route_gap`` (a model with experts): the reference follows the program's
  routes, and this is the largest gap, in the reference's router logits, by
  which an expert left out beats one taken (``reference/decoder.py``).

A number that is not finite fails, and so does one that the cell's limits
list and the run does not give.
"""
from __future__ import annotations

import math
import statistics

__all__ = ["MOVED", "NUMBERS", "compare", "judge"]

MOVED = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "update_gap", "route_gap")


def _worst(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    leaves = list(leaves)
    floor = statistics.median(ref[p] for p in leaves)
    gaps = {p: abs(prog[p] - ref[p]) / max(ref[p], floor, 1e-30)
            for p in leaves}
    leaf = max(gaps, key=lambda p: (not math.isfinite(gaps[p]), gaps[p]))
    return gaps[leaf], leaf


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers (and the leaves that set the last two)."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different "
                         "numbers of steps")
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    floor = statistics.median(g_ref.values())
    moved = [p for p in g_ref if g_ref[p] >= MOVED * floor]
    grad_gap, grad_leaf = _worst(prog["grad_norms"], g_ref, g_ref)
    update_gap, update_leaf = _worst(prog["delta_norms"], ref["delta_norms"],
                                     moved)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "update_gap": update_gap, "grad_leaf": grad_leaf,
           "update_leaf": update_leaf,
           "left_out": sorted(set(g_ref) - set(moved))}
    if ref.get("route_gap") is not None:
        out["route_gap"] = ref["route_gap"]
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: [reading, limit]})."""
    checks = {k: [readings.get(k, math.inf), float(limits[k])]
              for k in NUMBERS if k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
