"""Public wrappers around the port's kernels: port of
``repro/kernels/ops.py``.

``twin_schedule_pass`` is the policy-batched scheduling pass on one
shared snapshot: every policy of the pool ranks the same queue, and K1'
(``kernels.policy_eval.policy_eval_pass``) runs one pass per order.  The
kernel inputs are built as ``repro/kernels/ref.py::kernel_inputs_from_state``
builds them: priority keys of non-queued slots are +inf before the
stable argsort, and the end times of jobs that are not running are +inf.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.backfill import priority_order
from repro_torch.core.state import RUNNING, SimState
from repro_torch.kernels import policy_eval as _pe


def twin_schedule_pass(state: SimState, pool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass per policy of ``pool`` (a (k,) tensor of integer policy
    ids, or a ``PolicySpec`` of k rows) over the unbatched ``state``.
    Returns (started (k, J) bool, free nodes after the pass (k,) int32):
    the reference's values, in the port's dtypes."""
    jobs = state.jobs
    order = priority_order(state, pool)
    run_end = torch.where(jobs.state == RUNNING, jobs.end_t, torch.inf)
    return _pe.policy_eval_pass(order, jobs.state, jobs.nodes,
                                jobs.est_runtime, run_end, state.free_nodes,
                                state.now)
