"""Job traces drawn in bulk with NumPy from one generator: every trace of
a mix at once, as (S, n) arrays of submission time, nodes, walltime
estimate and true runtime (float64 times, int nodes).

``poisson``: exponential inter-arrival gaps; nodes uniform on the
inclusive range (capped at the cluster); estimates lognormal between the
walltime bounds (median at their geometric mean, a quarter of the log
range as sigma) and clipped to them; true runtime = estimate × a uniform
accuracy, at least 1 s.

``paper``: the SchedTwin paper's four-phase synthetic workload (§4.1):
one job every ``gap`` seconds, each phase's nodes and walltimes uniform
on its ranges, the same accuracy rule.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def poisson(rng: np.random.Generator, S: int, n_jobs: int, total_nodes: int,
            mean_gap: float, node_range, walltime_range,
            accuracy) -> Dict[str, np.ndarray]:
    shape = (S, n_jobs)
    lo_w, hi_w = (float(v) for v in walltime_range)
    submit = np.cumsum(rng.exponential(mean_gap, shape), axis=1)
    nodes = rng.integers(node_range[0], min(node_range[1], total_nodes) + 1,
                         shape)
    mu = np.log(np.sqrt(lo_w * hi_w))
    sigma = np.log(hi_w / lo_w) / 4.0
    est = np.clip(rng.lognormal(mu, sigma, shape), lo_w, hi_w)
    acc = rng.uniform(accuracy[0], accuracy[1], shape)
    return {"submit": submit, "nodes": nodes, "est": est,
            "true": np.maximum(1.0, est * acc)}


def paper(rng: np.random.Generator, S: int, phases, gap: float,
          accuracy) -> Dict[str, np.ndarray]:
    nodes, est = [], []
    for ph in phases:
        shape = (S, int(ph["n_jobs"]))
        nodes.append(rng.integers(ph["nodes"][0], ph["nodes"][1] + 1, shape))
        est.append(rng.uniform(ph["walltime"][0], ph["walltime"][1], shape))
    nodes, est = np.concatenate(nodes, 1), np.concatenate(est, 1)
    acc = rng.uniform(accuracy[0], accuracy[1], est.shape)
    submit = np.broadcast_to(np.arange(est.shape[1]) * float(gap),
                             est.shape).copy()
    return {"submit": submit, "nodes": nodes, "est": est,
            "true": np.maximum(1.0, est * acc)}


def draw(spec: Dict, rng: np.random.Generator, total_nodes: int
         ) -> Dict[str, np.ndarray]:
    """The traces a mix's ``traces`` entry describes."""
    kind = spec["generator"]
    if kind == "poisson":
        return poisson(rng, int(spec["scenarios"]), int(spec["n_jobs"]),
                       total_nodes, float(spec["mean_gap"]),
                       spec["node_range"], spec["walltime_range"],
                       spec["accuracy"])
    if kind == "paper":
        return paper(rng, int(spec["scenarios"]), spec["phases"],
                     float(spec["gap"]), spec["accuracy"])
    raise ValueError(f"unknown trace generator {kind!r}")


def table_width(n_jobs: int) -> int:
    """The job table the program stacks traces of ``n_jobs`` into by
    default: the next power of two above the longest trace, at least 64."""
    return max(64, 1 << int(np.ceil(np.log2(max(n_jobs, 1) + 1))))


def padded(tr: Dict[str, np.ndarray], max_jobs: int, total_nodes: int
           ) -> Dict[str, np.ndarray]:
    """The traces as (S, max_jobs) float32/int32 rows, slot j = job j,
    padding slots zero and invalid."""
    S, n = tr["nodes"].shape
    if n > max_jobs:
        raise ValueError(f"{n} jobs a trace exceed the {max_jobs}-slot table")
    out = {}
    for name, dt in (("submit", np.float32), ("nodes", np.int32),
                     ("est", np.float32), ("true", np.float32)):
        a = np.zeros((S, max_jobs), dt)
        a[:, :n] = tr[name]
        out[name] = a
    out["valid"] = np.zeros((S, max_jobs), bool)
    out["valid"][:, :n] = True
    out["total"] = np.full(S, total_nodes, np.int32)
    return out
