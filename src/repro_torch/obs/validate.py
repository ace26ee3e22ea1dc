"""Flight-recorder dump validation (schema + required-span assertions);
a copy of ``repro.obs.validate``, so each package accepts the other's dumps.

Library functions validate a single dump pair; the CLI walks a trace
directory (as produced by ``--trace-dir``), validates every ``*.jsonl`` /
``*.trace.json`` file against the schema, and optionally requires that
named spans/events appear somewhere in the dumps — the CI obs smoke uses
this to assert the partition/heal recovery path was witnessed:

    python -m repro_torch.obs.validate TRACE_DIR \
        --require-span crosspod.partition --require-span crosspod.heal
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .recorder import load_jsonl

__all__ = ["validate_events", "validate_chrome", "validate_dir"]

_SPAN_KEYS = {"type", "name", "track", "t0", "t1", "span_id", "parent_id",
              "attrs"}
_EVENT_KEYS = {"type", "name", "track", "t", "span_id", "parent_id",
               "attrs"}


def validate_events(events: list[dict], *, where: str = "") -> list[str]:
    """Schema-check recorder dicts; returns a list of violations."""
    problems = []
    for i, rec in enumerate(events):
        loc = f"{where}#{i}"
        if not isinstance(rec, dict):
            problems.append(f"{loc}: not an object")
            continue
        kind = rec.get("type")
        if kind == "span":
            missing = _SPAN_KEYS - set(rec)
            if missing:
                problems.append(f"{loc}: span missing {sorted(missing)}")
                continue
            if not (isinstance(rec["t0"], (int, float))
                    and isinstance(rec["t1"], (int, float))
                    and rec["t1"] >= rec["t0"]):
                problems.append(f"{loc}: span has invalid t0/t1")
        elif kind == "event":
            missing = _EVENT_KEYS - set(rec)
            if missing:
                problems.append(f"{loc}: event missing {sorted(missing)}")
                continue
            if not isinstance(rec["t"], (int, float)):
                problems.append(f"{loc}: event has non-numeric t")
        else:
            problems.append(f"{loc}: unknown record type {kind!r}")
            continue
        if not isinstance(rec["name"], str) or not rec["name"]:
            problems.append(f"{loc}: empty name")
        if not isinstance(rec["attrs"], dict):
            problems.append(f"{loc}: attrs is not an object")
    return problems


def validate_chrome(doc: dict, *, where: str = "") -> list[str]:
    """Schema-check a Chrome ``trace_event`` JSON document."""
    problems = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return [f"{where}: missing traceEvents"]
    if not isinstance(doc["traceEvents"], list):
        return [f"{where}: traceEvents is not a list"]
    for i, ev in enumerate(doc["traceEvents"]):
        loc = f"{where}#{i}"
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"{loc}: missing {k!r}")
        ph = ev.get("ph")
        if ph == "X" and "dur" not in ev:
            problems.append(f"{loc}: complete event missing dur")
        elif ph not in ("X", "i"):
            problems.append(f"{loc}: unexpected phase {ph!r}")
        if not isinstance(ev.get("ts", 0), (int, float)):
            problems.append(f"{loc}: non-numeric ts")
    return problems


def validate_dir(trace_dir: str, *, require_spans: list[str] | None = None
                 ) -> tuple[list[str], dict]:
    """Validate every dump in ``trace_dir``.  Returns (problems, summary)
    where summary has files/events counts and the set of span names seen."""
    problems: list[str] = []
    names: set[str] = set()
    jsonls = sorted(glob.glob(os.path.join(trace_dir, "*.jsonl")))
    chromes = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")))
    n_events = 0
    for path in jsonls:
        try:
            events = load_jsonl(path)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{path}: unreadable ({e})")
            continue
        problems.extend(validate_events(events,
                                        where=os.path.basename(path)))
        names |= {rec.get("name") for rec in events
                  if isinstance(rec, dict) and isinstance(rec.get("name"),
                                                          str)}
        n_events += len(events)
    for path in chromes:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{path}: unreadable ({e})")
            continue
        problems.extend(validate_chrome(doc,
                                        where=os.path.basename(path)))
    if not jsonls:
        problems.append(f"{trace_dir}: no *.jsonl dumps found")
    for span in (require_spans or []):
        if span not in names:
            problems.append(f"required span {span!r} missing from dumps "
                            f"(saw {len(names)} distinct names)")
    summary = {"jsonl_files": len(jsonls), "chrome_files": len(chromes),
               "events": n_events, "span_names": sorted(names)}
    return problems, summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="validate flight-recorder dumps in a trace directory")
    ap.add_argument("trace_dir")
    ap.add_argument("--require-span", action="append", default=[],
                    help="span/event name that must appear in some dump "
                         "(repeatable)")
    ap.add_argument("--list-spans", action="store_true",
                    help="print every distinct span/event name seen")
    args = ap.parse_args(argv)
    problems, summary = validate_dir(args.trace_dir,
                                     require_spans=args.require_span)
    print(f"{summary['jsonl_files']} jsonl + {summary['chrome_files']} "
          f"chrome dump(s), {summary['events']} event records, "
          f"{len(summary['span_names'])} distinct names")
    if args.list_spans:
        for name in summary["span_names"]:
            print(f"  {name}")
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print("trace schema OK"
          + (f"; required spans present: {', '.join(args.require_span)}"
             if args.require_span else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
