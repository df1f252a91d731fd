"""A backlog drawn from a batch system's queue table: jobs of several
queues arriving interleaved, each inside its queue's node and walltime
limits, as (S, n) arrays in the layout of ``traces.draw`` (float64
times, int nodes) with the queue of each job beside them.

Each job draws its queue by the mix's ``shares`` (by job count), then:
arrivals Poisson (exponential gaps of ``mean_gap`` seconds); nodes
log-uniform over the queue's inclusive integer range (capped at the
cluster); the walltime estimate lognormal between the walltime floor
and the queue's cap, with the ``poisson`` generator's rule (median at
their geometric mean, a quarter of the log range as sigma), clipped to
them; true runtime = estimate × a uniform accuracy, at least 1 s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _limits(queues: Dict, shares: Dict, total_nodes: int):
    """The shares and (lo, hi) node and walltime limits of the queues
    the mix draws from, in the order of ``shares``, node limits capped
    at the cluster."""
    p = np.array([float(v) for v in shares.values()])
    if abs(p.sum() - 1.0) > 1e-9 or (p < 0).any():
        raise ValueError(f"queue shares must be >= 0 and sum to 1: {shares}")
    nodes = np.array([queues[q]["nodes"] for q in shares], np.int64)
    wall = np.array([queues[q]["walltime"] for q in shares], np.float64)
    nodes = np.minimum(nodes, total_nodes)
    if (nodes[:, 0] < 1).any() or (wall[:, 0] <= 0).any() \
            or (nodes[:, 0] > nodes[:, 1]).any() \
            or (wall[:, 0] > wall[:, 1]).any():
        raise ValueError(f"bad queue limits: {queues}")
    return p, nodes, wall


def draw(rng: np.random.Generator, S: int, n_jobs: int, total_nodes: int,
         queues: Dict, shares: Dict, mean_gap: float,
         accuracy) -> Dict[str, np.ndarray]:
    p, node_lim, wall_lim = _limits(queues, shares, total_nodes)
    shape = (S, n_jobs)
    q = rng.choice(len(p), size=shape, p=p)
    submit = np.cumsum(rng.exponential(mean_gap, shape), axis=1)
    lo_n, hi_n = node_lim[q, 0], node_lim[q, 1]
    u = rng.uniform(np.log(lo_n), np.log(hi_n + 1.0))
    nodes = np.clip(np.floor(np.exp(u)).astype(np.int64), lo_n, hi_n)
    lo_w, hi_w = wall_lim[q, 0], wall_lim[q, 1]
    mu = np.log(np.sqrt(lo_w * hi_w))
    sigma = np.log(hi_w / lo_w) / 4.0
    est = np.clip(rng.lognormal(mu, sigma), lo_w, hi_w)
    acc = rng.uniform(accuracy[0], accuracy[1], shape)
    return {"submit": submit, "nodes": nodes, "est": est,
            "true": np.maximum(1.0, est * acc), "queue": q}


def backlog(spec: Dict, cfg: Dict, rng: np.random.Generator,
            scenarios: int = 1) -> Dict[str, np.ndarray]:
    """The backlog a mix's ``backlog`` entry (``generator`` ``queues``)
    describes on the configuration's cluster and queue table."""
    if spec["generator"] != "queues":
        raise ValueError(f"not a queue mix: {spec['generator']!r}")
    return draw(rng, scenarios, int(spec["n_jobs"]), int(cfg["total_nodes"]),
                cfg["queues"], spec["shares"], float(spec["mean_gap"]),
                spec["accuracy"])
