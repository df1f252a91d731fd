"""Parallel what-if exploration (§3.3) — port of ``repro/core/whatif.py``.

The paper forks k simulator processes (one per policy) sharing one
database; here the forks are a leading batch axis drained in lock-step
by ``engine.DrainEngine``.  ``decide`` is the thin public entry point.
Ensemble decisions, the legacy vmap path and the sharded grids are not
ported yet (ROADMAP A6, A8).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.core import scoring
from repro_torch.core.engine import Decision, DrainEngine, EnginePool
from repro_torch.core.objective import ObjectiveLike
from repro_torch.core.policies import (PAPER_POOL, PolicyPool, PolicySpec,
                                       parse_pool)
from repro_torch.core.state import SimState
from repro_torch.device import DeviceLike

__all__ = ["Decision", "PolicyPool", "decide", "paper_pool", "pool_array"]

#: Anything ``decide`` takes as a pool.
PoolArg = Union[PolicyPool, PolicySpec, str, torch.Tensor]


def _engine_pool(pool: PoolArg) -> EnginePool:
    if isinstance(pool, PolicyPool):
        return pool.spec
    if isinstance(pool, str):
        return parse_pool(pool).spec
    return pool  # PolicySpec stack or legacy id tensor


def decide(state: SimState, pool: PoolArg,
           objective: ObjectiveLike = None, *,
           weights: Optional[scoring.ScoreWeights] = None,
           engine: Optional[DrainEngine] = None,
           device: DeviceLike = "cuda") -> Decision:
    """One scheduling cycle: fork k sims, score, select, extract the
    qrun set.  Runs on ``engine`` if given, else on a new engine on
    ``device``."""
    engine = engine if engine is not None else DrainEngine(device=device)
    return engine.decide(state, _engine_pool(pool), objective,
                         weights=weights)


def paper_pool() -> torch.Tensor:
    return torch.tensor(PAPER_POOL, dtype=torch.int32)


def pool_array(ids: Sequence[int]) -> torch.Tensor:
    """Legacy id pool in the CALLER's order (position = tie-break)."""
    return torch.tensor(list(ids), dtype=torch.int32)
