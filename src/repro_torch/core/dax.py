"""Pegasus DAX (XML) workflow parser.

The paper reads its workflows "as input in the form of a DAX file".  Our
benchmarks use structural generators (no network access), but real DAX
files from the Pegasus workflow gallery load directly::

    wf = load_dax("Montage_100.xml")

Supports the DAX 2/3 schema subset the simulators use: <job> runtime
attribute, <uses> file sizes for transfer volumes, <child>/<parent> edges.

A copy of ``repro.core.dax``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

from .workflow import Task, Workflow

__all__ = ["load_dax", "parse_dax"]


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_dax(xml_text: str, *, default_runtime: float = 10.0,
              name: str = "dax") -> Workflow:
    root = ET.fromstring(xml_text)
    tasks: list[Task] = []
    tid_by_id: dict[str, int] = {}
    out_files: dict[str, tuple[int, float]] = {}   # file -> (producer, MB)
    in_files: dict[int, list[tuple[str, float]]] = {}

    for el in root:
        if _strip(el.tag) != "job":
            continue
        jid = el.attrib["id"]
        runtime = float(el.attrib.get("runtime",
                                      el.attrib.get("run", default_runtime)))
        tid = len(tasks)
        tasks.append(Task(tid, el.attrib.get("name", jid), max(runtime, 1e-3)))
        tid_by_id[jid] = tid
        in_files[tid] = []
        for u in el:
            if _strip(u.tag) != "uses":
                continue
            fname = u.attrib.get("file", u.attrib.get("name", ""))
            size_mb = float(u.attrib.get("size", 0)) / 1e6
            link = u.attrib.get("link", "")
            if link == "output":
                out_files[fname] = (tid, size_mb)
            elif link == "input":
                in_files[tid].append((fname, size_mb))

    deps: dict[tuple[int, int], float] = {}
    # explicit control edges
    for el in root:
        if _strip(el.tag) != "child":
            continue
        child = tid_by_id.get(el.attrib["ref"])
        if child is None:
            continue
        for p in el:
            if _strip(p.tag) != "parent":
                continue
            parent = tid_by_id.get(p.attrib["ref"])
            if parent is None or parent == child:
                continue
            deps.setdefault((child, parent), 0.0)
    # data-flow volumes from file producers
    for child, files in in_files.items():
        for fname, size_mb in files:
            prod = out_files.get(fname)
            if prod is None or prod[0] == child:
                continue
            key = (child, prod[0])
            deps[key] = deps.get(key, 0.0) + max(size_mb, 1e-6)

    dep_list = [(c, p, max(d, 1e-6)) for (c, p), d in deps.items()]
    return Workflow(name, tasks, dep_list)


def load_dax(path: str, **kw) -> Workflow:
    with open(path) as f:
        return parse_dax(f.read(), name=path.rsplit("/", 1)[-1], **kw)
