"""The paper's own configuration (§4.1) and the replay grid's — the
port's copy of ``repro.configs.schedtwin``.

``make_traces`` / ``make_scenarios`` draw with numpy from the same seeds
as the reference, so both packages build the same arrays bit for bit;
``make_engine`` builds the port's ``DrainEngine`` on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.engine import DrainEngine
from repro_torch.core.objective import Objective, resolve_goal
from repro_torch.core.policies import (EXTENDED_POOL, PAPER_POOL, PolicyPool,
                                       normalize_pool)
from repro_torch.core.scoring import ScoreWeights
from repro_torch.device import DeviceLike

#: DRAS-style 25-point sweep (5x5 grid over the WFP exponent and the
#: aging timescale) beside the 7 static specs: k=32 forks.
DRAS_SWEEP_POOL = "extended,wfp:a=1..5x5:tau=600..7200x5"


@dataclasses.dataclass(frozen=True)
class TwinConfig:
    total_nodes: int = 32             # 32-node PBS cluster (CloudLab)
    max_jobs: int = 256
    # legacy policy ids or a pool grammar string (policies.parse_pool)
    pool: Union[str, Tuple[int, ...]] = tuple(PAPER_POOL)  # WFP, FCFS, SJF
    # the administrator's goal: a grammar string or an ``Objective``
    objective: Union[str, Objective] = "score"
    # deprecated legacy goal spelling, lifted to the paper score
    weights: Optional[ScoreWeights] = None
    ensemble: int = 1
    ensemble_noise: float = 0.3
    trace_seed: int = 0
    accuracy: Tuple[float, float] = (0.5, 1.0)     # true/estimated runtime
    # engine backend ("reference" | "cuda" | "auto") and its device
    backend: str = "auto"
    device: DeviceLike = "cuda"

    def make_engine(self) -> DrainEngine:
        """The policy-batched engine this config selects."""
        return DrainEngine(backend=self.backend, device=self.device)

    def make_pool(self) -> PolicyPool:
        return normalize_pool(self.pool)

    def make_objective(self) -> Objective:
        """The resolved optimization goal (legacy ``weights`` lifted)."""
        if self.weights is not None and self.objective == "score":
            return resolve_goal(None, self.weights)   # legacy spelling
        return resolve_goal(self.objective, self.weights)


PAPER_TWIN = TwinConfig()
EXTENDED_TWIN = TwinConfig(pool=tuple(EXTENDED_POOL))
SWEEP_TWIN = TwinConfig(pool=DRAS_SWEEP_POOL)


@dataclasses.dataclass(frozen=True)
class ReplayGridConfig:
    """A (scenario × policy) baseline grid for the replay engine
    (DESIGN.md §6): S traces of one workload family × the candidate
    pool, one batched replay (``engine.replay_grid``).  Used by
    ``twin_loop --replay-grid``."""

    scenarios: int = 8
    trace: str = "poisson"            # poisson | bursty | paper
    n_jobs: int = 48
    total_nodes: int = 32
    mean_gap: float = 8.0
    node_range: Tuple[int, int] = (1, 16)
    walltime_range: Tuple[float, float] = (30.0, 900.0)
    pool: Union[str, Tuple[int, ...]] = tuple(EXTENDED_POOL)   # P=7
    # goal of the grid's per-scenario selection (``ReplayOutcome.best``)
    objective: Union[str, Objective] = "score"
    seed: int = 0
    backend: str = "auto"
    device: DeviceLike = "cuda"

    def make_engine(self) -> DrainEngine:
        return DrainEngine(backend=self.backend, device=self.device)

    def make_pool(self) -> PolicyPool:
        return normalize_pool(self.pool)

    def make_objective(self) -> Objective:
        return resolve_goal(self.objective)

    def make_traces(self):
        """One trace per scenario: the same family, consecutive seeds."""
        from repro_torch.cluster.workload import (bursty_trace,
                                                  paper_synthetic_trace,
                                                  poisson_trace)
        traces = []
        for s in range(self.scenarios):
            seed = self.seed + s
            if self.trace == "paper":
                traces.append(paper_synthetic_trace(seed=seed))
            elif self.trace == "bursty":
                traces.append(bursty_trace(
                    self.n_jobs, self.total_nodes, self.mean_gap,
                    self.node_range, self.walltime_range, seed=seed))
            elif self.trace == "poisson":
                traces.append(poisson_trace(
                    self.n_jobs, self.total_nodes, self.mean_gap,
                    self.node_range, self.walltime_range, seed=seed))
            else:
                raise ValueError(f"unknown trace family {self.trace!r}")
        return traces

    def make_scenarios(self):
        """The stacked, padded ``workload.ScenarioSet``."""
        from repro_torch.cluster.workload import stack_scenarios
        return stack_scenarios(self.make_traces(), self.total_nodes)


REPLAY_GRID = ReplayGridConfig()
