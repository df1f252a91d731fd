"""The arithmetic of the metric readers under ``metrics/``: each reads a
run's spans, counts or device trace, and returns None where the run
recorded nothing to read (no unit, no K1 launch, no trace)."""
from __future__ import annotations

import statistics
from typing import Optional

from twinbench.roofline import k1_bound_s


def _spans(run, name):
    return run.rec.spans.get(name) or None


def setup_s(run) -> Optional[float]:
    return run.setup_s


def mean_unit_s(run) -> Optional[float]:
    """Total time of the window's units over their count."""
    s = _spans(run, "unit")
    return sum(s) / len(s) if s else None


def forks_per_s(run) -> Optional[float]:
    """All forks of the window's grids over their total time."""
    s = _spans(run, "unit")
    return sum(run.rec.counts["forks"]) / sum(s) if s else None


def mean_ms(run, name) -> Optional[float]:
    s = _spans(run, name)
    return 1e3 * statistics.fmean(s) if s else None


def ingest_ms(run) -> Optional[float]:
    """A cycle's time outside the decision: publication, ingest, qrun."""
    u, d = _spans(run, "unit"), _spans(run, "decide")
    if not u or not d:
        return None
    return 1e3 * statistics.fmean(a - b for a, b in zip(u, d))


def k1_per_unit(run) -> Optional[float]:
    n = run.rec.counts.get("k1")
    return statistics.fmean(n) if n and sum(n) else None


def step_ms(run) -> Optional[float]:
    """The window's grid time over its replay iterations (K1 launches)."""
    s, n = _spans(run, "unit"), run.rec.counts.get("k1")
    return 1e3 * sum(s) / sum(n) if s and n and sum(n) else None


def kernels_per_iter(run) -> Optional[float]:
    p = run.profile
    return p["kernels"] / p["k1_launches"] if p else None


def k1_roofline(run) -> Optional[float]:
    """Per cent of K1's bound in its device time, launch for launch: the
    mean least bytes of the window's launches at the HBM rate over the
    mean device time of its K1 launches."""
    p = run.profile
    if not p or not p["k1_count"] or not p["k1_counted"]:
        return None
    return 100.0 * k1_bound_s(p["k1_bytes"] / p["k1_counted"]) / (
        p["k1_s"] / p["k1_count"])


def idle_share(run) -> Optional[float]:
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"]) if p else None


def peak_gib(run) -> Optional[float]:
    n = run.rec.counts.get("peak_bytes")
    return max(n) / 2**30 if n else None
