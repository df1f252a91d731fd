"""SchedTwin core on PyTorch: the port of ``repro.core``."""
from repro_torch.core.engine import (BACKENDS, Decision, DrainEngine,
                                     FanOutcome, ReplayOutcome)
from repro_torch.core.events import (BusReadError, DeadLetter, Event,
                                     EventBus, EventKind, SeqTracker,
                                     read_with_retry, validate_event)
from repro_torch.core.fan import FanSpec, normalize_fan, pruned_fan_grid
from repro_torch.core.objective import (Objective, parse_objective,
                                        resolve_goal, validate_objective)
from repro_torch.core.policies import (EXTENDED_POOL, FAM_EXP, FAM_LIN,
                                       FAM_WFP, PAPER_POOL, PolicyPool,
                                       PolicySpec, normalize_pool, parse_pool,
                                       policy_name, spec_rows, theta_pool)
from repro_torch.core.state import (DONE, INVALID, QUEUED, RUNNING, JobTable,
                                    SimState, empty_state)
from repro_torch.core.race import (RaceOutcome, RaceSpec, decide_race,
                                   normalize_race, race_grid)
from repro_torch.core.twin import SchedTwin
from repro_torch.core.whatif import (decide, decide_ensemble,
                                     decide_legacy_vmap, pool_array,
                                     sharded_fan_grid, sharded_race_grid,
                                     sharded_replay_grid, sharded_whatif)

__all__ = [
    "BACKENDS", "Decision", "DrainEngine",
    "ReplayOutcome", "FanOutcome",
    "FanSpec", "normalize_fan", "pruned_fan_grid",
    "RaceSpec", "RaceOutcome", "normalize_race", "race_grid",
    "decide_race",
    "Event", "EventBus", "EventKind", "BusReadError", "DeadLetter",
    "SeqTracker", "read_with_retry", "validate_event",
    "Objective", "parse_objective", "resolve_goal", "validate_objective",
    "EXTENDED_POOL", "PAPER_POOL", "PolicyPool", "PolicySpec",
    "FAM_LIN", "FAM_WFP", "FAM_EXP", "normalize_pool", "parse_pool",
    "policy_name", "spec_rows", "theta_pool",
    "DONE", "INVALID", "QUEUED", "RUNNING", "JobTable", "SimState",
    "empty_state", "SchedTwin", "decide", "decide_ensemble",
    "decide_legacy_vmap", "pool_array", "sharded_whatif",
    "sharded_replay_grid", "sharded_fan_grid", "sharded_race_grid",
]
