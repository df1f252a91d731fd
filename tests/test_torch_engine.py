"""The port's ``DrainEngine.decide`` against the JAX engine's.

Corpus: ``tests/test_engine.py``'s 60 snapshots (J=48), extended pool,
``reference`` backend on both sides.  The port runs under the four
combinations of ``dynamic_bounds`` x ``hoist_static`` (goal ``score``)
and under the goals ``avg_wait``, ``lex:avg_wait,makespan`` and
``min:avg_wait@util>=0.85``; the JAX engine runs its default knobs (its
own ``tests/test_hotloop.py`` holds all knob combinations bit-identical).

Tolerances:
  * ``policy_index``, ``run_mask`` and ``deadlocked``: identical;
  * ``costs`` and every ``cost_terms`` entry: ``rtol=1e-5``.  They are
    computed from ``state_metrics``, whose f32 sums run in another order
    than XLA's (ROADMAP C4).  A winner that differs where two costs are
    within that tolerance is a near-tie flip; flips are collected and
    listed in the failure message (none are expected, none were found);
  * rank-composed costs (``lex:``, ``min:...@``): equal, except at forks
    whose metric ties another fork's in one package and misses it by an
    ulp in the other (sums that tie in exact arithmetic).  The dense
    rank then differs there, the winner does not (snapshot 57: SJF and
    LXF ``avg_wait``);
  * ``schedule_pass_starts`` (the emulator's k=1 pass): identical;
  * radar helpers and ``summarize_pool``: rtol 1e-5 (the metrics');
    ``validate_invariants``: identical.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jscoring
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import EXTENDED_POOL
from repro.core.policies import parse_pool as jparse
from repro.core.policies import static_spec as jstatic
from repro.core.state import validate_invariants as jvalid
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import scoring as tscoring
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.objective import parse_objective
from repro_torch.core.policies import parse_pool as tparse
from repro_torch.core.policies import static_spec as tstatic
from repro_torch.core.state import validate_invariants as tvalid

from conftest import make_cluster_state
from torch_threads import one_thread  # noqa: F401


N_SNAPSHOTS = 60
MAX_JOBS = 48
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _corpus():
    """(JAX state, port state) pairs of the corpus, made once."""
    out = []
    for seed in range(N_SNAPSHOTS):
        js = make_cluster_state(
            max_jobs=MAX_JOBS, total_nodes=32, seed=seed,
            n_queued=4 + seed % 16, n_running=seed % 5,
            now=100.0 + 37.0 * seed)
        out.append((js, state_from_numpy(state_to_numpy(js), device="cpu")))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_decisions(goal, pool_grammar="extended"):
    """The JAX engine's decisions on the corpus (default knobs: its own
    tests/test_hotloop.py holds every knob combination bit-identical)."""
    jeng, jpool = JEngine("reference"), jparse(pool_grammar).spec
    return tuple(jeng.decide(js, jpool, goal) for js, _ in _corpus())


def _near_tied(jd, td):
    """Forks whose equality with another fork, in some cost term, holds
    in one package and not the other while the two values are within
    RTOL: the dense ranks of lex/min goals may differ exactly there."""
    out = set()
    for term, tv in td.cost_terms.items():
        a, b = np.asarray(jd.cost_terms[term]), tv.numpy()
        close = np.isclose(a[:, None], a[None, :], rtol=RTOL)
        split = (a[:, None] == a[None, :]) != (b[:, None] == b[None, :])
        out.update(np.nonzero((close & split).any(1))[0].tolist())
    return out


def _compare(jd, td, ctx, flips, elementwise=True):
    j_costs = np.asarray(jd.costs)
    t_costs = td.costs.numpy()
    j_best, t_best = int(jd.policy_index), int(td.policy_index)
    near = set() if elementwise else _near_tied(jd, td)
    if j_best != t_best:
        if (np.isclose(j_costs[j_best], t_costs[t_best], rtol=RTOL)
                or {j_best, t_best} <= near):
            flips.append((ctx, j_best, t_best, j_costs[j_best],
                          t_costs[t_best]))
            return
        raise AssertionError(f"{ctx}: winner {t_best} != {j_best}")
    np.testing.assert_array_equal(td.run_mask.numpy(),
                                  np.asarray(jd.run_mask), err_msg=ctx)
    np.testing.assert_array_equal(td.deadlocked.numpy(),
                                  np.asarray(jd.deadlocked), err_msg=ctx)
    assert list(td.cost_terms) == list(jd.cost_terms), ctx
    for term, v in td.cost_terms.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jd.cost_terms[term]),
                                   rtol=RTOL, err_msg=f"{ctx} {term}")
    if elementwise:
        np.testing.assert_allclose(t_costs, j_costs, rtol=RTOL, err_msg=ctx)
    else:   # composed ranks: equal except at near-tied forks
        keep = np.array([i not in near for i in range(len(j_costs))])
        np.testing.assert_array_equal(t_costs[keep], j_costs[keep],
                                      err_msg=ctx)


def _run(goal, **knobs):
    teng = TEngine("reference", device="cpu", **knobs)
    tpool = tparse("extended").spec
    elementwise = parse_objective(goal).elementwise
    flips = []
    for i, ((_, ts), jd) in enumerate(zip(_corpus(), _jax_decisions(goal))):
        _compare(jd, teng.decide(ts, tpool, goal),
                 f"snapshot {i} goal {goal} {knobs}", flips, elementwise)
    assert not flips, f"near-tie winner flips: {flips}"


@pytest.mark.parametrize("dynamic_bounds", [True, False])
@pytest.mark.parametrize("hoist_static", [True, False])
def test_decide_all_knob_combinations(dynamic_bounds, hoist_static):
    _run("score", dynamic_bounds=dynamic_bounds, hoist_static=hoist_static)


@pytest.mark.parametrize("goal", ["avg_wait", "lex:avg_wait,makespan",
                                  "min:avg_wait@util>=0.85"])
def test_decide_goals(goal):
    _run(goal)


def test_decide_all_static_pool_and_legacy_ids():
    """An all-static pool hoists every row (no per-event sort); a legacy
    id pool takes the integer-key oracle path."""
    jeng, teng = JEngine("reference"), TEngine("reference", device="cpu")
    flips = []
    ids = list(EXTENDED_POOL)
    for i, (js, ts) in enumerate(_corpus()):
        if i % 4:
            continue
        _compare(jeng.decide(js, jparse("fcfs,sjf,saf,ljf").spec),
                 teng.decide(ts, tparse("fcfs,sjf,saf,ljf").spec),
                 f"static {i}", flips)
        _compare(jeng.decide(js, jnp.asarray(ids, jnp.int32)),
                 teng.decide(ts, torch.tensor(ids, dtype=torch.int32)),
                 f"ids {i}", flips)
    assert not flips, f"near-tie winner flips: {flips}"


def test_schedule_pass_starts_matches_single_pass():
    jeng, teng = JEngine("reference"), TEngine("reference", device="cpu")
    for i, (js, ts) in enumerate(_corpus()):
        if i % 5:
            continue
        for pid in EXTENDED_POOL:
            np.testing.assert_array_equal(
                teng.schedule_pass_starts(ts, tstatic(pid)).numpy(),
                np.asarray(jeng.schedule_pass_starts(js, jstatic(pid))),
                err_msg=f"snapshot {i} policy {pid}")
            np.testing.assert_array_equal(
                teng.schedule_pass_starts(ts, pid).numpy(),
                np.asarray(jeng.schedule_pass_starts(js, pid)),
                err_msg=f"snapshot {i} id {pid}")


def test_engine_knobs_and_backend_registry():
    eng = TEngine(device="cpu")
    assert eng.backend == "reference" and eng.device.type == "cpu"
    assert TEngine("cuda", device="cpu").backend == "cuda"
    with pytest.raises(ValueError, match="unknown pass backend"):
        TEngine("pallas", device="cpu")
    # the cuda backend on CPU tensors runs the same plain pass
    js = make_cluster_state(max_jobs=MAX_JOBS, seed=11, n_queued=14,
                            n_running=3)
    pool = tparse("extended").spec
    ts = state_from_numpy(state_to_numpy(js), device="cpu")
    a = TEngine("cuda", device="cpu").decide(ts, pool)
    b = TEngine("reference", device="cpu").decide(ts, pool)
    assert int(a.policy_index) == int(b.policy_index)
    np.testing.assert_array_equal(a.costs.numpy(), b.costs.numpy())


def test_scoring_helpers_and_invariants_match():
    """Radar helpers and ``summarize_pool`` on one decision's metrics
    (rtol 1e-5, the metrics' own tolerance), and ``validate_invariants``
    on every snapshot (identical booleans)."""
    js, ts = _corpus()[7]
    names = tparse("extended").names
    jd = _jax_decisions("score")[7]
    td = TEngine("reference", device="cpu").decide(ts,
                                                   tparse("extended").spec)
    jsum = jscoring.summarize_pool(names, jd.metrics)
    tsum = tscoring.summarize_pool(names, td.metrics)
    for name in names:
        for key in jsum[name]:
            np.testing.assert_allclose(tsum[name][key], jsum[name][key],
                                       rtol=RTOL)
    assert tscoring.radar_report(jsum) == jscoring.radar_report(jsum)
    assert tscoring.radar_normalize(jsum) == jscoring.radar_normalize(jsum)
    for js, ts in _corpus():
        assert tvalid(ts) == jvalid(js)
