"""A copy of the benchmark's folder with cells small enough for the CPU,
added as files alone: two configurations, three mixes and a
``BENCHMARK.json`` naming them beside the shipped metrics and the
decision cycle's."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Dict

from twinbench import harness

CONFIGS = {
    "tiny-16": {"total_nodes": 16, "max_jobs": 64,
                "pool": "paper,wfp:a=1..2x2:tau=600..1200x2"},
    "tiny-paper": {"total_nodes": 32, "max_jobs": 256, "pool": "paper"},
}
POISSON = {"generator": "poisson", "node_range": [1, 4],
           "walltime_range": [300.0, 7200.0], "accuracy": [0.3, 1.0]}
LIMITS = {"exact_diff": 0, "cost_gap": 1e-5}
TRAFFIC = {
    "cycle4": {"entry": "cycle",
               "backlog": dict(POISSON, n_jobs=40, mean_gap=4.0),
               "fan": {"n": 4, "runtime_noise": 0.3, "failure_prob": 0.5},
               "goal": "cvar:0.5:score", "obits": 2, "warm_cycles": 1,
               "episode_cycles": 2,
               "profile": {"start": 2, "warm": 1, "active": 3},
               "check": {"cycles": 2},
               "limits": LIMITS},
    "farm6": {"entry": "farm",
              "traces": dict(POISSON, scenarios=6, n_jobs=30, mean_gap=60.0),
              "goal": "score", "profile": {"start": 2, "warm": 1, "active": 3},
              "check": {"scenarios": 4}, "limits": LIMITS},
}
# The decision cycle's metrics, which no shipped cell reports: the copy
# adds them for its cycle cell as entries alone (their readers ship).
CYCLE = ["tiny-16.cycle4", "tiny-paper.cycle2"]
CYCLE_METRICS = {
    "end_to_end": [
        {"name": "cycle_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": CYCLE}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "cycle_s", "workloads": CYCLE}
        for name, unit, better, source, layer in (
            ("ingest_ms.cycle", "ms", "lower", "host_clock",
             "twin entry and ingest"),
            ("decide_ms.cycle", "ms", "lower", "program_span",
             "decide and drain"),
            ("iters.cycle", "iters", "lower", "program_counter",
             "decide and drain"),
            ("kernels_per_iter.cycle", "kernels/iter", "lower",
             "device_trace", "plain torch ops of the loops"),
            ("k1_roofline.cycle", "%", "higher", "device_trace",
             "K1 pass kernel"),
            ("idle_share.cycle", "%", "lower", "device_trace", "device"))]}
WORKLOADS = {"tiny-16.cycle4": ("tiny-16", "cycle4"),
             "tiny-16.farm6": ("tiny-16", "farm6"),
             "tiny-paper.farm4": ("tiny-paper", "farm4"),
             "tiny-paper.cycle2": ("tiny-paper", "cycle2")}


def paper_cycle_mix() -> Dict:
    """The shipped decision-cycle mix on the paper's workload with two
    futures, two cycles an episode and one cycle re-decided."""
    mix = json.loads((harness.HERE / "traffic" / "fan256-cycle.json")
                     .read_text())
    mix["fan"]["n"] = 2
    mix.update(episode_cycles=2, check={"cycles": 1},
               profile={"start": 2, "warm": 1, "active": 3})
    return mix


def paper_mix() -> Dict:
    shipped = json.loads((harness.HERE / "traffic" / "farm16384.json")
                         .read_text())
    mix = copy.deepcopy(TRAFFIC["farm6"])
    mix["traces"] = dict(shipped["traces"], scenarios=4)
    return mix


def make(tmp: Path) -> Path:
    """The copy under ``tmp``; returns its root (the folder holding
    ``configs/`` and the rest) with ``BENCHMARK.json`` beside it."""
    root = tmp / "twinbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in dict(TRAFFIC, farm4=paper_mix(),
                          cycle2=paper_cycle_mix()).items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1,
                           "why": "CPU test"}
                          for w, (c, t) in WORKLOADS.items()]
    farms = ["tiny-16.farm6", "tiny-paper.farm4"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = farms
    for kind, entries in CYCLE_METRICS.items():
        bench[kind] += copy.deepcopy(entries)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, workload: str, seed: int = 3, seconds: float = 0.0,
        trace: bool = False) -> harness.Run:
    """One run on the CPU (the chip check skipped); the result fields
    land in ``run.extra["out"]``."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, workload, root)
    r = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                    device="cpu", root=root)
    r.extra["out"] = harness.measure(r)
    return r
