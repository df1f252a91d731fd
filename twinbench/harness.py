"""One run of one cell: find its files by name, set up, measure a window,
check the outputs against the reference, and assemble the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own under the benchmark's folder, found by the
name ``BENCHMARK.json`` gives it:

  configs/<config>.json    the deployment
  traffic/<mix>.json       the mix's parameters; ``entry`` names its loop
  entries/<entry>.py       ``setup(run)``, ``unit(state, rec)``, ``check(state, run)``
  metrics/<metric>.py      ``read(run)``: a number, or None when there
                           is nothing to read
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from twinbench.compare import Check, report

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(root: Path, kind: str, name: str) -> Dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"twinbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    entry: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reported(metrics: List[Dict], cell: str, e2e: List[str]) -> List[Dict]:
    """The metrics a cell reports: those listing it, and those without a
    list whose end-to-end metric the cell reports."""
    return [m for m in metrics
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m.get("moves", m["name"]) in e2e)]


def find_cell(bench: Dict, workload: str, root: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    traffic = load_json(root, "traffic", w["traffic"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(root, "configs", w["config"]),
                traffic=traffic,
                entry=load_module(root, "entries", traffic["entry"]),
                end_to_end=e2e,
                per_layer=_reported(bench["per_layer"], workload,
                                    [m["name"] for m in e2e]))


class Recorder:
    """Spans (seconds) and counts an entry records, one per unit."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counts: Dict[str, List[int]] = defaultdict(list)

    def span(self, name: str, seconds: float) -> None:
        self.spans[name].append(seconds)

    def count(self, name: str, n: int) -> None:
        self.counts[name].append(n)


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: Path = HERE
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    rec: Recorder = dataclasses.field(default_factory=Recorder)
    setup_s: float = 0.0
    profile: Optional[Dict] = None
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    extra: Dict = dataclasses.field(default_factory=dict)


def measure(run: Run) -> Dict:
    """Set up, measure ``run.seconds`` of units, read the memory peak,
    profile one more unit when tracing, then check; returns the result
    line's fields (without ``device``).  An entry's ``unit`` runs the next
    block of the window's work, records a ``unit`` span for each timed
    unit in it (a decision cycle, a grid), and returns how many it ran
    (None: one); ``attempted`` counts them."""
    entry = run.cell.entry
    state = entry.setup(run)
    run.setup_s = time.perf_counter() - run.t_start
    _log(f"set-up {run.setup_s:.2f} s")
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    while True:
        run.attempted += entry.unit(state, run.rec) or 1
        if time.perf_counter() >= t_end:
            break
    _log(f"window {time.perf_counter() - t0:.2f} s, {run.attempted} units: "
         + " ".join(f"{u:.4f}" for u in run.rec.spans.get("unit", ())))
    run.extra["memory_peak_bytes"] = _peak_bytes(run.device)
    if run.trace:
        from twinbench.trace import K1Window
        with K1Window(**run.cell.traffic["profile"]) as win:
            entry.unit(state, Recorder())
        run.profile = win.reduce()
    t0 = time.perf_counter()
    run.checks = entry.check(state, run)
    _log(f"check {time.perf_counter() - t0:.2f} s; exact_diff parts "
         + json.dumps(run.extra.get("exact_parts")))
    out = {"correct": run.failed == 0 and all(c.ok for c in run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": read_metrics(run)}
    if run.trace and run.profile is not None:
        out["breakdown"] = {k: run.profile[k]
                            for k in ("device_ops", "idle_gaps")}
    return out


def _log(msg: str) -> None:
    print(f"twinbench: {msg}", file=sys.stderr, flush=True)


def read_metrics(run: Run) -> Dict:
    chosen = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {}
    for m in chosen:
        value = load_module(run.root, "metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _peak_bytes(device: str) -> int:
    import torch
    if device != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def guard_imports(modules=None) -> None:
    """Refuse to report when JAX or the JAX package is among ``modules``
    (default: those loaded in this process), by whole top-level name."""
    names = sys.modules if modules is None else modules
    found = sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"twinbench: {', '.join(found)} loaded in the "
                         f"measuring process; no result")


def result_line(run: Run, out: Dict) -> str:
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips,
              "memory_peak_bytes": run.extra["memory_peak_bytes"]}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["wall_s"]
    line = dict(out, device=device)
    line["checks"] = report(run.checks)
    return json.dumps(line)
