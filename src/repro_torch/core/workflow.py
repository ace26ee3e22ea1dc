"""Workflow DAG representation + scientific-workflow generators.

Faithful to the paper's setting (Section 4.1): a workflow is read from a
DAX-like description as three matrices

  1. (Task x Task)  data to be transferred between dependent tasks
  2. (Task x VM)    runtime of a task on a given VM
  3. (VM x VM)      transmission rate between two VMs

We provide structural generators for the four workflows used in the paper
(Montage, CyberShake, LIGO/Inspiral, SIPHT) following the shape/runtime
characterization of Juve et al., "Characterizing and Profiling Scientific
Workflows" (the paper's [5]).

A copy of ``repro.core.workflow``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.  Every draw from
``np.random.default_rng`` stays in the same order: keep it so.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = [
    "Task",
    "Workflow",
    "CloudEnvironment",
    "generate_workflow",
    "WORKFLOW_TYPES",
]


@dataclasses.dataclass(frozen=True)
class Task:
    """One vertex of the workflow DAG."""

    tid: int
    name: str
    runtime: float  # reference runtime in seconds (on a unit-speed VM)
    priority: int = 0


class Workflow:
    """A DAG of :class:`Task` with data-volume annotated dependencies.

    ``deps`` holds ``(child, parent, data_mb)`` triples, matching the paper's
    ``dependenciesList = {(t, t', d) | t' is a parent of t sending d units}``.
    """

    def __init__(self, name: str, tasks: list[Task],
                 deps: Iterable[tuple[int, int, float]]):
        self.name = name
        self.tasks = list(tasks)
        self.deps: list[tuple[int, int, float]] = [
            (int(c), int(p), float(d)) for (c, p, d) in deps
        ]
        n = len(self.tasks)
        self.parents: dict[int, list[tuple[int, float]]] = {t.tid: [] for t in tasks}
        self.children: dict[int, list[tuple[int, float]]] = {t.tid: [] for t in tasks}
        for child, parent, d in self.deps:
            if not (0 <= child < n and 0 <= parent < n):
                raise ValueError(f"dep ({child},{parent}) out of range")
            if child == parent:
                raise ValueError("self dependency")
            self.parents[child].append((parent, d))
            self.children[parent].append((child, d))
        self._check_acyclic()

    # -- structure ---------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def entry_tasks(self) -> list[int]:
        return [t.tid for t in self.tasks if not self.parents[t.tid]]

    def exit_tasks(self) -> list[int]:
        return [t.tid for t in self.tasks if not self.children[t.tid]]

    def topo_order(self) -> list[int]:
        indeg = {t.tid: len(self.parents[t.tid]) for t in self.tasks}
        stack = sorted([t for t, d in indeg.items() if d == 0])
        order: list[int] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v, _ in self.children[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != self.n_tasks:
            raise ValueError("workflow graph has a cycle")
        return order

    def _check_acyclic(self) -> None:
        self.topo_order()

    def depth(self) -> dict[int, int]:
        """Longest #edges from any entry task."""
        d = {t: 0 for t in range(self.n_tasks)}
        for u in self.topo_order():
            for v, _ in self.children[u]:
                d[v] = max(d[v], d[u] + 1)
        return d

    def descendant_counts(self) -> dict[int, int]:
        """|descendants(t)| per task (reachability count, not path count)."""
        order = self.topo_order()
        reach: dict[int, set[int]] = {t: set() for t in range(self.n_tasks)}
        for u in reversed(order):
            s: set[int] = set()
            for v, _ in self.children[u]:
                s.add(v)
                s |= reach[v]
            reach[u] = s
        return {t: len(s) for t, s in reach.items()}


class CloudEnvironment:
    """The (Task x VM) runtime and (VM x VM) transfer-rate matrices.

    * ``time_on_vm[t, r]`` — seconds for task ``t`` on VM ``r`` (paper's
      ``timeOnVm``).  Built from per-VM speed factors plus mild per-pair noise
      (heterogeneous Condor pool).
    * ``transfer_rate[r, r']`` — MB/s on the dedicated two-way line between
      VMs; ``inf`` on the diagonal (no self-transfer cost).
    """

    def __init__(self, workflow: Workflow, n_vms: int = 20, *,
                 seed: int = 0, speed_spread: float = 0.5,
                 base_bandwidth_mbps: float = 40.0):
        rng = np.random.default_rng(seed)
        self.n_vms = int(n_vms)
        runtimes = np.array([t.runtime for t in workflow.tasks])
        # VM speed factors in [1-spread, 1+spread]; "good" VMs are fast for most tasks.
        self.vm_speed = 1.0 + speed_spread * (2.0 * rng.random(n_vms) - 1.0)
        noise = 1.0 + 0.1 * rng.standard_normal((workflow.n_tasks, n_vms))
        noise = np.clip(noise, 0.7, 1.3)
        self.time_on_vm = runtimes[:, None] / self.vm_speed[None, :] * noise
        self.time_on_vm = np.maximum(self.time_on_vm, 1e-3)
        rate = base_bandwidth_mbps * (0.5 + rng.random((n_vms, n_vms)))
        rate = 0.5 * (rate + rate.T)  # two-way dedicated line: symmetric
        np.fill_diagonal(rate, np.inf)
        self.transfer_rate = rate

    # -- paper Eq. (1) -----------------------------------------------------
    def avg_exec_time(self, t: int) -> float:
        return float(np.mean(self.time_on_vm[t]))

    # -- paper Eq. (2): mean over distinct VM pairs -------------------------
    def avg_transfer_time(self, data_mb: float) -> float:
        r = self.transfer_rate
        mask = ~np.eye(self.n_vms, dtype=bool)
        return float(np.mean(data_mb / r[mask]))

    def transfer_time(self, data_mb: float, r_src: int, r_dst: int) -> float:
        if r_src == r_dst:
            return 0.0
        return float(data_mb / self.transfer_rate[r_src, r_dst])


# ---------------------------------------------------------------------------
# Workflow generators (structure approximating the Pegasus DAX families)
# ---------------------------------------------------------------------------

def _runtime(rng: np.random.Generator, mean: float, cv: float = 0.4) -> float:
    """Gamma-distributed runtime (Chen & Deelman model the paper cites)."""
    shape = 1.0 / (cv * cv)
    return float(rng.gamma(shape, mean / shape))


def _montage(n: int, rng: np.random.Generator):
    """Montage: I/O bound, many small tasks, wide levels + reduce spine."""
    tasks: list[Task] = []
    deps: list[tuple[int, int, float]] = []

    def add(name: str, mean_rt: float, priority: int = 0) -> int:
        tid = len(tasks)
        tasks.append(Task(tid, name, _runtime(rng, mean_rt), priority))
        return tid

    # allocate level widths so total ~= n
    w = max(4, (n - 5) // 3)          # mProject / mBackground width
    nd = max(4, n - 5 - 2 * w)        # mDiffFit width (~edge overlaps)
    proj = [add("mProjectPP", 12.0) for _ in range(w)]
    diff = []
    for i in range(nd):
        t = add("mDiffFit", 8.0)
        a, b = proj[i % w], proj[(i + 1) % w]
        deps.append((t, a, 2.0 + rng.random()))
        if b != a:
            deps.append((t, b, 2.0 + rng.random()))
        diff.append(t)
    concat = add("mConcatFit", 25.0, priority=1)
    for t in diff:
        deps.append((concat, t, 0.5))
    bg_model = add("mBgModel", 40.0, priority=2)
    deps.append((bg_model, concat, 0.5))
    bgs = []
    for i in range(w):
        t = add("mBackground", 10.0)
        deps.append((t, proj[i], 2.0 + rng.random()))
        deps.append((t, bg_model, 0.3))
        bgs.append(t)
    imgtbl = add("mImgtbl", 15.0, priority=1)
    for t in bgs:
        deps.append((imgtbl, t, 3.0))
    madd = add("mAdd", 60.0, priority=3)
    deps.append((madd, imgtbl, 1.0))
    for t in bgs:
        deps.append((madd, t, 3.0 + rng.random()))
    shrink = add("mShrink", 12.0, priority=1)
    deps.append((shrink, madd, 8.0))
    jpeg = add("mJPEG", 5.0, priority=1)
    deps.append((jpeg, shrink, 2.0))
    return tasks, deps


def _cybershake(n: int, rng: np.random.Generator):
    """CyberShake: CPU/memory intensive; pairs of SGT extracts feeding many
    seismogram syntheses, then peak-value + zip reduces."""
    tasks: list[Task] = []
    deps: list[tuple[int, int, float]] = []

    def add(name: str, mean_rt: float, priority: int = 0) -> int:
        tid = len(tasks)
        tasks.append(Task(tid, name, _runtime(rng, mean_rt), priority))
        return tid

    n_pairs = max(2, n // 20)
    per_pair = max(2, (n - 2 * n_pairs - 2) // (2 * n_pairs))
    sgt = [add("ExtractSGT", 110.0, priority=2) for _ in range(2 * n_pairs)]
    peaks = []
    for p in range(n_pairs):
        for _ in range(per_pair):
            syn = add("SeismogramSynthesis", 48.0)
            deps.append((syn, sgt[2 * p], 30.0 + 5 * rng.random()))
            deps.append((syn, sgt[2 * p + 1], 30.0 + 5 * rng.random()))
            pk = add("PeakValCalcOkaya", 2.0)
            deps.append((pk, syn, 0.5))
            peaks.append((syn, pk))
    zip_seis = add("ZipSeis", 20.0, priority=1)
    zip_psa = add("ZipPSA", 20.0, priority=1)
    for syn, pk in peaks:
        deps.append((zip_seis, syn, 1.0))
        deps.append((zip_psa, pk, 0.2))
    return tasks, deps


def _ligo(n: int, rng: np.random.Generator):
    """LIGO Inspiral: heavily CPU bound; TmpltBank->Inspiral->Thinca pipeline
    repeated twice with group fan-ins."""
    tasks: list[Task] = []
    deps: list[tuple[int, int, float]] = []

    def add(name: str, mean_rt: float, priority: int = 0) -> int:
        tid = len(tasks)
        tasks.append(Task(tid, name, _runtime(rng, mean_rt), priority))
        return tid

    group = 5
    n_groups = max(2, n // (2 * group + 2 + group + 1))
    tb_all, groups1 = [], []
    for _ in range(n_groups):
        tbs = [add("TmpltBank", 180.0, priority=1) for _ in range(group)]
        ins = []
        for tb in tbs:
            i = add("Inspiral", 460.0, priority=2)
            deps.append((i, tb, 1.0))
            ins.append(i)
        th = add("Thinca", 6.0)
        for i in ins:
            deps.append((th, i, 0.8))
        tb_all.extend(tbs)
        groups1.append(th)
    finals = []
    for th in groups1:
        trig = add("TrigBank", 6.0)
        deps.append((trig, th, 0.5))
        ins2 = []
        for _ in range(group):
            i2 = add("Inspiral2", 420.0, priority=2)
            deps.append((i2, trig, 1.0))
            ins2.append(i2)
        th2 = add("Thinca2", 6.0, priority=1)
        for i2 in ins2:
            deps.append((th2, i2, 0.8))
        finals.append(th2)
    sink = add("Sire", 10.0, priority=3)
    for th2 in finals:
        deps.append((sink, th2, 0.5))
    return tasks, deps


def _sipht(n: int, rng: np.random.Generator):
    """SIPHT: bioinformatics; wide Patser fan-in + heterogeneous mid-stage."""
    tasks: list[Task] = []
    deps: list[tuple[int, int, float]] = []

    def add(name: str, mean_rt: float, priority: int = 0) -> int:
        tid = len(tasks)
        tasks.append(Task(tid, name, _runtime(rng, mean_rt), priority))
        return tid

    n_pats = max(4, n - 12)
    pats = [add("Patser", 1.5) for _ in range(n_pats)]
    pc = add("PatserConcat", 3.0, priority=1)
    for p in pats:
        deps.append((pc, p, 0.1))
    transterm = add("Transterm", 35.0, priority=1)
    findterm = add("FindTerm", 90.0, priority=2)
    rnamotif = add("RNAMotif", 28.0, priority=1)
    blast = add("Blast", 210.0, priority=2)
    srna = add("SRNA", 20.0, priority=2)
    for t in (transterm, findterm, rnamotif, blast):
        deps.append((srna, t, 2.0))
    deps.append((srna, pc, 0.5))
    ffn = add("FFN_Blast", 120.0, priority=1)
    deps.append((ffn, srna, 4.0))
    paralog = add("BlastParalogues", 60.0)
    deps.append((paralog, srna, 4.0))
    synteny = add("BlastSynteny", 60.0)
    deps.append((synteny, srna, 4.0))
    candidate = add("BlastCandidate", 45.0)
    deps.append((candidate, srna, 4.0))
    annotate = add("SRNAAnnotate", 12.0, priority=3)
    for t in (ffn, paralog, synteny, candidate):
        deps.append((annotate, t, 1.0))
    return tasks, deps


_GENERATORS = {
    "montage": _montage,
    "cybershake": _cybershake,
    "ligo": _ligo,
    "inspiral": _ligo,  # alias used by the paper
    "sipht": _sipht,
}

WORKFLOW_TYPES = ("montage", "cybershake", "ligo", "sipht")


# per-family time scales: makespans land in the paper's regime (tens of
# minutes on 20 VMs) while preserving the CPU-intensity ordering
# LIGO >> CyberShake > SIPHT > Montage of Juve et al. [5]
_RUNTIME_SCALE = {"montage": 15.0, "cybershake": 5.0, "ligo": 2.5,
                  "inspiral": 2.5, "sipht": 8.0}


def generate_workflow(kind: str, n_tasks: int = 100, *, seed: int = 0,
                      runtime_scale: float | None = None) -> Workflow:
    """Generate a workflow of approximately ``n_tasks`` tasks.

    ``runtime_scale`` overrides the per-family default time scale; absolute
    scales are chosen so the Weibull MTBF / log-normal MTTR distributions of
    Section 4.1 are meaningful against the makespan.
    """
    kind = kind.lower()
    if kind not in _GENERATORS:
        raise ValueError(f"unknown workflow type {kind!r}; pick from {WORKFLOW_TYPES}")
    rng = np.random.default_rng(seed)
    scale = _RUNTIME_SCALE[kind] if runtime_scale is None else runtime_scale
    tasks, deps = _GENERATORS[kind](int(n_tasks), rng)
    tasks = [Task(t.tid, t.name, t.runtime * scale, t.priority)
             for t in tasks]
    return Workflow(f"{kind}-{len(tasks)}", tasks, deps)
