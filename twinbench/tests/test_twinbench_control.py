"""``correct`` has to fail: the control (the reference in place of the
program, its times stored in bfloat16) and each fault a cell can have,
planted in the program underneath a run.  One chip has no exchange
between chips to leave out."""
import json

import pytest
import torch

from twinbench import control, harness
from twinbench.tests import tiny


@pytest.mark.parametrize("workload", sorted(tiny.WORKLOADS))
def test_control_is_not_correct(tiny_root, workload):
    bench = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, workload, tiny_root)
    (ctl, parts), (same, _) = control.readings(cell, 21, "cpu")
    assert not all(c.ok for c in ctl), ctl
    assert all(c.value > c.limit for c in ctl), (ctl, parts)
    assert all(c.value == 0 for c in same), same


def unchanged_step(mp):
    """Every iteration returns its state without the pass's starts."""
    from repro_torch.core import des
    mp.setattr(des, "apply_starts", lambda st, started: st)


def half_batch(mp):
    """Metrics of the second half of the forks replaced by the first
    half's: the reductions average over half the batch."""
    from repro_torch.core import des, engine
    full = des.state_metrics

    def half(state, mask, runtime=None):
        m = full(state, mask, runtime)
        k = m.avg_wait.shape[0]
        h = (k + 1) // 2
        return type(m)(*(torch.cat([v[:h], v[:k - h]]) for v in m))
    mp.setattr(engine, "state_metrics", half)


def altered_answer(mp):
    """The winner is the next policy where it is chosen."""
    from repro_torch.core import engine, scoring
    select, grid = scoring.select_policy, engine.grid_select
    mp.setattr(scoring, "select_policy",
               lambda c: (select(c) + 1) % c.shape[-1])

    def shifted(objective, metrics, dead, P):
        costs, best = grid(objective, metrics, dead, P)
        return costs, (best + 1) % P
    mp.setattr(engine, "grid_select", shifted)


@pytest.mark.parametrize("fault", (unchanged_step, half_batch,
                                   altered_answer))
@pytest.mark.parametrize("workload", ("tiny-16.cycle4", "tiny-16.farm6"))
def test_fault_makes_run_incorrect(tiny_root, workload, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny.run(tiny_root, workload, seed=13)
    assert not r.extra["out"]["correct"], r.checks
