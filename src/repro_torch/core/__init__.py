"""SchedTwin core on PyTorch: the port of ``repro.core``."""
from repro_torch.core.engine import (PASS_BACKENDS, Decision, DrainEngine,
                                     register_backend)
from repro_torch.core.events import Event, EventBus, EventKind
from repro_torch.core.objective import (Objective, parse_objective,
                                        resolve_goal, validate_objective)
from repro_torch.core.policies import (EXTENDED_POOL, PAPER_POOL, PolicyPool,
                                       PolicySpec, normalize_pool, parse_pool)
from repro_torch.core.state import (DONE, INVALID, QUEUED, RUNNING, JobTable,
                                    SimState, empty_state)
from repro_torch.core.twin import SchedTwin
from repro_torch.core.whatif import decide

__all__ = [
    "PASS_BACKENDS", "Decision", "DrainEngine", "register_backend",
    "Event", "EventBus", "EventKind",
    "Objective", "parse_objective", "resolve_goal", "validate_objective",
    "EXTENDED_POOL", "PAPER_POOL", "PolicyPool", "PolicySpec",
    "normalize_pool", "parse_pool",
    "DONE", "INVALID", "QUEUED", "RUNNING", "JobTable", "SimState",
    "empty_state", "SchedTwin", "decide",
]
