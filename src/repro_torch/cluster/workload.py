"""Workload generation — port of ``repro/cluster/workload.py`` (numpy
only, copied so that a seed gives the identical trace).

``paper_synthetic_trace`` reproduces the §4.1 evaluation trace: 150 jobs
in four phases on a 32-node cluster, 5 s inter-arrival.  True runtimes
are a fraction of the requested walltime (users overestimate, §3.2); the
twin never sees them.  ``poisson_trace`` / ``bursty_trace`` are the
generic family: flat Poisson arrivals and the same process under a
sinusoidal (diurnal) rate.  Scenario stacking for the replay engine is
not ported yet (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobSpec:
    job_id: int
    submit_t: float
    nodes: int
    est_runtime: float   # user-requested walltime (visible to scheduler/twin)
    true_runtime: float  # ground truth (emulator only)
    tag: str = ""        # phase or job-class label


@dataclasses.dataclass(frozen=True)
class Phase:
    n_jobs: int
    nodes: Tuple[int, int]        # inclusive range
    walltime: Tuple[float, float] # seconds, inclusive range
    tag: str


PAPER_PHASES: Sequence[Phase] = (
    Phase(25, (2, 4), (60.0, 180.0), "warmup"),
    Phase(35, (16, 20), (500.0, 700.0), "burst"),
    Phase(40, (6, 8), (200.0, 300.0), "steady"),
    Phase(50, (2, 4), (30.0, 90.0), "tail"),  # "short-job tail ... of seconds"
)
PAPER_TOTAL_NODES = 32
PAPER_ARRIVAL_GAP = 5.0  # seconds per job


def paper_synthetic_trace(seed: int = 0,
                          accuracy: Tuple[float, float] = (0.5, 1.0),
                          arrival_gap: float = PAPER_ARRIVAL_GAP,
                          phases: Sequence[Phase] = PAPER_PHASES,
                          rng: Optional[np.random.Generator] = None,
                          ) -> List[JobSpec]:
    """The §4.1 four-phase synthetic workload (150 jobs).

    ``accuracy`` is the true/estimated runtime ratio range; estimates are
    the phase walltimes.  Deterministic given ``seed``; pass ``rng=`` to
    draw from an explicit caller-owned generator instead (resumable
    streams — ``seed`` is then ignored).
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    jid = 0
    for ph in phases:
        for _ in range(ph.n_jobs):
            nodes = int(rng.integers(ph.nodes[0], ph.nodes[1] + 1))
            est = float(rng.uniform(ph.walltime[0], ph.walltime[1]))
            acc = float(rng.uniform(accuracy[0], accuracy[1]))
            jobs.append(JobSpec(
                job_id=jid, submit_t=t, nodes=nodes,
                est_runtime=est, true_runtime=max(1.0, est * acc),
                tag=ph.tag))
            jid += 1
            t += arrival_gap
    return jobs


def _sample_job(rng: np.random.Generator, jid: int, t: float,
                total_nodes: int, node_range: Tuple[int, int],
                walltime_range: Tuple[float, float],
                accuracy: Tuple[float, float], heavy_tail: bool,
                tag: str) -> JobSpec:
    """One job draw shared by the Poisson-family trace generators
    (identical RNG call order: nodes, est, acc)."""
    lo_w, hi_w = walltime_range
    nodes = int(rng.integers(node_range[0],
                             min(node_range[1], total_nodes) + 1))
    if heavy_tail:
        mu = np.log(np.sqrt(lo_w * hi_w))
        sigma = np.log(hi_w / lo_w) / 4.0
        est = float(np.clip(rng.lognormal(mu, sigma), lo_w, hi_w))
    else:
        est = float(rng.uniform(lo_w, hi_w))
    acc = float(rng.uniform(accuracy[0], accuracy[1]))
    return JobSpec(jid, t, nodes, est, max(1.0, est * acc), tag)


def poisson_trace(n_jobs: int, total_nodes: int, mean_gap: float,
                  node_range: Tuple[int, int],
                  walltime_range: Tuple[float, float],
                  seed: int = 0,
                  accuracy: Tuple[float, float] = (0.3, 1.0),
                  heavy_tail: bool = True,
                  rng: Optional[np.random.Generator] = None,
                  ) -> List[JobSpec]:
    """Generic Poisson-arrival workload with (optionally) lognormal
    walltimes — matches the wide Polaris-style variability of Figure 1.
    ``rng=`` substitutes an explicit caller-owned generator for the
    ``seed``-derived one (deterministic, resumable streams)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        jobs.append(_sample_job(rng, jid, t, total_nodes, node_range,
                                walltime_range, accuracy, heavy_tail,
                                "poisson"))
    return jobs


def bursty_trace(n_jobs: int, total_nodes: int, mean_gap: float,
                 node_range: Tuple[int, int],
                 walltime_range: Tuple[float, float],
                 seed: int = 0,
                 accuracy: Tuple[float, float] = (0.3, 1.0),
                 heavy_tail: bool = True,
                 period: float = 3600.0,
                 amplitude: float = 0.8,
                 phase: float = 0.0,
                 rng: Optional[np.random.Generator] = None,
                 ) -> List[JobSpec]:
    """Bursty/diurnal arrivals: a nonhomogeneous Poisson process whose
    rate is sinusoidally modulated on top of ``poisson_trace``'s flat
    rate,

        rate(t) = (1 + amplitude * sin(2*pi*t/period + phase)) / mean_gap,

    so arrivals alternate between rush-hour bursts (rate up to
    (1+amplitude)x the mean) and quiet troughs — the regime where
    backfill-friendly policies and aggressive aging pull apart, which a
    flat-Poisson evaluation never exercises.  ``amplitude`` in [0, 1);
    0 reduces to ``poisson_trace``'s marginal statistics.  Job sizes
    and walltimes are drawn exactly as in ``poisson_trace``.  ``rng=``
    substitutes an explicit caller-owned generator for the
    ``seed``-derived one — the same knob the on-device fan exposes via
    ``FanSpec.seed``, so host traces and device fans are both
    deterministic and resumable.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        # thin an exponential draw by the instantaneous rate at t: the
        # local mean gap is mean_gap / (1 + A sin(...)).
        rate = 1.0 + amplitude * np.sin(2.0 * np.pi * t / period + phase)
        t += float(rng.exponential(mean_gap) / max(rate, 1e-9))
        jobs.append(_sample_job(rng, jid, t, total_nodes, node_range,
                                walltime_range, accuracy, heavy_tail,
                                "bursty"))
    return jobs
