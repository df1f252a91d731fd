"""Policy scoring (§3.4) and the radar evaluation (§4.2) — port of
``repro/core/scoring.py``.

    Score(p) = 0.25*maxWT(p) + 0.25*maxSD(p) + 0.25*avgWT(p) + 0.25*avgSD(p)

over the jobs waiting at decision time, minimized; waits in minutes.
Ties break by pool position: ``select_policy`` is an argmin that keeps
the first index (``torch.argmin`` does so on the CPU and on CUDA).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.des import DrainMetrics


class ScoreWeights(NamedTuple):
    max_wait: float = 0.25
    max_slowdown: float = 0.25
    avg_wait: float = 0.25
    avg_slowdown: float = 0.25


PAPER_WEIGHTS = ScoreWeights()
_WT_SCALE = 1.0 / 60.0  # seconds -> minutes


def policy_cost(metrics: DrainMetrics,
                weights: ScoreWeights = PAPER_WEIGHTS) -> torch.Tensor:
    """The paper's Score(p), as a cost to minimize (broadcasts over a
    leading policy axis)."""
    return (weights.max_wait * metrics.max_wait * _WT_SCALE
            + weights.max_slowdown * metrics.max_slowdown
            + weights.avg_wait * metrics.avg_wait * _WT_SCALE
            + weights.avg_slowdown * metrics.avg_slowdown)


def select_policy(costs: torch.Tensor) -> torch.Tensor:
    """argmin with first-occurrence tie-break = paper's priority order."""
    return torch.argmin(costs)


# ----------------------------------------------------------------------
# Kiviat (radar) chart evaluation — Figure 3 (host-side numpy).
# ----------------------------------------------------------------------

RADAR_AXES = ("avg_wait", "max_wait", "avg_slowdown", "max_slowdown",
              "utilization")
_COST_AXES = ("avg_wait", "max_wait", "avg_slowdown", "max_slowdown")


def radar_normalize(per_policy: Dict[str, Dict[str, float]],
                    axes: tuple = RADAR_AXES,
                    cost_axes: tuple = _COST_AXES
                    ) -> Dict[str, Dict[str, float]]:
    """Min-max normalize each axis across policies: best radius 1,
    worst radius 0."""
    names = list(per_policy)
    out: Dict[str, Dict[str, float]] = {n: {} for n in names}
    for axis in axes:
        vals = np.array([per_policy[n][axis] for n in names],
                        dtype=np.float64)
        lo, hi = vals.min(), vals.max()
        span = hi - lo
        for n, v in zip(names, vals):
            if span <= 0:
                r = 1.0
            elif axis in cost_axes:
                r = (hi - v) / span
            else:
                r = (v - lo) / span
            out[n][axis] = float(r)
    return out


def radar_area(radii: Dict[str, float], axes: tuple = RADAR_AXES) -> float:
    """Area of the radar polygon over ``axes``."""
    r = np.array([radii[a] for a in axes], dtype=np.float64)
    ang = 2.0 * np.pi / len(r)
    return float(0.5 * np.sin(ang) * np.sum(r * np.roll(r, -1)))


def radar_report(per_policy: Dict[str, Dict[str, float]],
                 axes: tuple = RADAR_AXES,
                 cost_axes: tuple = _COST_AXES) -> Dict[str, float]:
    normed = radar_normalize(per_policy, axes, cost_axes)
    return {n: radar_area(v, axes) for n, v in normed.items()}


def summarize_pool(names, metrics: DrainMetrics
                   ) -> Dict[str, Dict[str, float]]:
    """Per-fork metric dicts from (k,)-leading metrics; ``names`` is a
    sequence of labels or a ``PolicyPool``."""
    if hasattr(names, "names"):
        names = names.names
    host = DrainMetrics(*(m.detach().cpu().numpy() for m in metrics))
    return {n: {"avg_wait": float(host.avg_wait[i]),
                "max_wait": float(host.max_wait[i]),
                "avg_slowdown": float(host.avg_slowdown[i]),
                "max_slowdown": float(host.max_slowdown[i]),
                "utilization": float(host.utilization[i]),
                "makespan": float(host.makespan[i])}
            for i, n in enumerate(names)}
