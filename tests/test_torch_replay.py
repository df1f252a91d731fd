"""The port's trace replay against the JAX package's, on the CPU.

Corpus: ``tests/test_replay.py``'s 6 random traces (poisson and bursty,
20 jobs, 16 nodes, ``MAX_JOBS = 64``) × ``EXTENDED_POOL`` = 42 (trace,
policy) combinations, plus traces on a 10 s grid where arrivals and ends
and several ends fall on the same instant.  ``DrainEngine("reference")``
on both sides; the JAX ``pallas`` backend (interpret mode) on one trace.

Tolerances:
  * ``start_t``, ``end_t``, ``deadlocked``, ``events``, ``iters`` and
    ``pass_invocations``: identical, against JAX and against the port's
    host emulator;
  * ``metrics`` and ``costs``: ``rtol=1e-5`` (f32 sums in torch's order,
    ROADMAP C4).  A winner that differs must be a near tie and is
    listed in the failure message (none are expected);
  * the fast emulator's ``metric_dict()``: equal to the host loop's;
  * the workload tools: identical arrays.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import workload as jwl
from repro.configs.schedtwin import ReplayGridConfig as JGridConfig
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import EXTENDED_POOL
from repro.core.policies import parse_pool as jparse
from repro.launch import twin_loop as jloop
from repro_torch.cluster import workload as twl
from repro_torch.cluster.emulator import ClusterEmulator, FailureSpec
from repro_torch.configs.schedtwin import ReplayGridConfig as TGridConfig
from repro_torch.core import des
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.engine import tile_pool
from repro_torch.core.events import EventBus
from repro_torch.core.objective import parse_objective
from repro_torch.core.policies import parse_pool as tparse
from repro_torch.core.state import DONE, QUEUED
from repro_torch.launch import twin_loop as tloop
from torch_threads import one_thread  # noqa: F401


MAX_JOBS = 64
RTOL = 1e-5
JREF = JEngine("reference")
TREF = TEngine("reference", device="cpu")
J_IDS = jnp.asarray(EXTENDED_POOL, dtype=jnp.int32)
T_IDS = torch.tensor(EXTENDED_POOL, dtype=torch.int32)


def random_traces(wl, n_traces=6, n_jobs=20, total_nodes=16):
    """``tests/test_replay.py::random_traces`` from package ``wl``."""
    out = []
    for i in range(n_traces):
        gen = wl.bursty_trace if i % 2 else wl.poisson_trace
        out.append(gen(n_jobs, total_nodes, 4.0 + i, (1, total_nodes - 4),
                       (30.0, 400.0), seed=100 + i))
    return out


def grid_traces(wl, seed, n_jobs=20, total_nodes=16):
    """A poisson trace with every time on a 10 s grid: arrivals land on
    ends and ends on ends."""
    on_grid = lambda x: float(max(10.0, 10.0 * np.round(x / 10.0)))
    out = []
    for j in wl.poisson_trace(n_jobs, total_nodes, 12.0, (1, 10),
                              (20.0, 200.0), seed=seed):
        est = on_grid(j.est_runtime)
        out.append(wl.JobSpec(j.job_id, 10.0 * np.round(j.submit_t / 10.0),
                              j.nodes, est, min(est, on_grid(j.true_runtime)),
                              "grid"))
    return out


def tie_trace(wl):
    """Four jobs end together at t=60 (start order decides which retires
    first); a full-cluster job arrives at t=60 exactly as they end."""
    J = wl.JobSpec
    return [J(0, 0.0, 4, 90.0, 60.0), J(1, 0.0, 4, 60.0, 60.0),
            J(2, 0.0, 4, 120.0, 60.0), J(3, 0.0, 4, 60.0, 60.0),
            J(4, 30.0, 16, 50.0, 30.0), J(5, 60.0, 16, 40.0, 40.0),
            J(6, 60.0, 2, 10.0, 10.0), J(7, 100.0, 3, 30.0, 30.0)]


CORPORA = {
    "random": lambda wl: random_traces(wl),
    "grid": lambda wl: [grid_traces(wl, s) for s in (1, 2, 3)],
    "ties": lambda wl: [tie_trace(wl)],
}


@functools.lru_cache(maxsize=None)
def _jax_replay(corpus, i, backend="reference"):
    trace = CORPORA[corpus](jwl)[i]
    scen = jwl.make_scenario(trace, 16, max_jobs=MAX_JOBS)
    return JEngine(backend).replay(scen, J_IDS)


def _port_replay(corpus, i, engine=TREF, pool=T_IDS):
    trace = CORPORA[corpus](twl)[i]
    return engine.replay(twl.make_scenario(trace, 16, max_jobs=MAX_JOBS),
                         pool)


def assert_same_outcome(t, j, ctx, times_only=False):
    """Port outcome ``t`` against JAX outcome ``j``."""
    for name in ("start_t", "end_t", "deadlocked", "events"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("iters", "pass_invocations"):
        assert int(getattr(t.result, name)) == int(getattr(j.result, name)), \
            f"{ctx} {name}"
    if times_only:
        return
    for name, v in t.metrics._asdict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(j.metrics,
                                                                  name)),
                                   rtol=RTOL, err_msg=f"{ctx} {name}")
    np.testing.assert_allclose(t.costs.numpy(), np.asarray(j.costs),
                               rtol=RTOL, err_msg=ctx)
    assert np.array_equal(t.best.numpy(), np.asarray(j.best)), ctx


def assert_same_port_outcome(a, b, ctx):
    """Two port outcomes, every field identical."""
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{ctx} {name}"
    for x, y in zip(a.metrics, b.metrics):
        assert torch.equal(x, y), ctx
    for name in ("iters", "pass_invocations"):
        assert int(getattr(a.result, name)) == int(getattr(b.result, name)), \
            f"{ctx} {name}"
    for x, y in zip(a.result.state.jobs, b.result.state.jobs):
        assert torch.equal(x, y), ctx


# ----------------------------------------------------------------------
# The port's replay against JAX's.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("i", range(6))
def test_replay_matches_jax_on_the_42_combos(i):
    """One trace × the 7 policies of ``EXTENDED_POOL`` a case: 42
    bitwise (trace, policy) combinations over the six cases."""
    assert_same_outcome(_port_replay("random", i), _jax_replay("random", i),
                        f"trace {i}")


@pytest.mark.parametrize("corpus,i", [("grid", 0), ("grid", 1), ("grid", 2),
                                      ("ties", 0)])
def test_replay_matches_jax_on_tied_event_times(corpus, i):
    out = _port_replay(corpus, i)
    assert_same_outcome(out, _jax_replay(corpus, i), f"{corpus} {i}")
    assert not out.deadlocked.any()


def test_replay_matches_jax_pallas():
    """7 combos against the JAX package's Pallas kernel (interpret)."""
    assert_same_outcome(_port_replay("random", 0),
                        _jax_replay("random", 0, "pallas"), "pallas",
                        times_only=True)


# ----------------------------------------------------------------------
# The port's replay against the port's host emulator.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", range(len(EXTENDED_POOL)))
def test_replay_matches_host_emulator(p):
    """Policy p on two random traces and a grid trace: the replay's
    start/end times are the host loop's, bitwise, and ``run(fast=True)``
    reports the host loop's metrics exactly."""
    pid = EXTENDED_POOL[p]
    for trace in random_traces(twl)[:2] + [grid_traces(twl, 1)]:
        n = len(trace)
        out = TREF.replay(twl.make_scenario(trace, 16, max_jobs=MAX_JOBS),
                          T_IDS)
        rep = ClusterEmulator(trace, 16, engine=TREF,
                              max_jobs=MAX_JOBS).run(policy_id=pid)
        np.testing.assert_array_equal(out.start_t[p, :n].numpy(),
                                      rep.start_t.astype(np.float32))
        np.testing.assert_array_equal(out.end_t[p, :n].numpy(),
                                      rep.end_t.astype(np.float32))
        fast = ClusterEmulator(trace, 16, engine=TREF,
                               max_jobs=MAX_JOBS).run(policy_id=pid,
                                                      fast=True)
        assert fast.metric_dict() == rep.metric_dict(), f"policy {pid}"


@pytest.mark.parametrize("policy", ["wfp", "fcfs", "wfp:a=2:tau=600"])
def test_fast_path_report_parity(policy):
    """run(fast=True) == the host loop: arrays, metrics and event counts,
    for legacy ids and parametric forks alike."""
    trace = twl.poisson_trace(24, 16, 6.0, (1, 12), (30.0, 300.0), seed=7)
    fork = tparse(policy).fork(0)
    a = ClusterEmulator(trace, 16, engine=TREF).run(policy_id=fork)
    b = ClusterEmulator(trace, 16, engine=TREF).run(policy_id=fork,
                                                    fast=True)
    np.testing.assert_array_equal(a.start_t, b.start_t)
    np.testing.assert_array_equal(a.end_t, b.end_t)
    assert a.metric_dict() == b.metric_dict()
    assert a.n_events == b.n_events


def test_fast_path_refusals():
    trace = twl.poisson_trace(8, 16, 6.0, (1, 8), (30.0, 120.0), seed=1)
    em = ClusterEmulator(trace, 16, engine=TREF,
                         failures=[FailureSpec(50.0, 4, 100.0)])
    with pytest.raises(ValueError, match="failure"):
        em.run(policy_id=0, fast=True)
    with pytest.raises(ValueError, match="static mode"):
        ClusterEmulator(trace, 16, engine=TREF).run(on_event=lambda: None,
                                                    fast=True)
    with pytest.raises(ValueError, match="stream bus events"):
        ClusterEmulator(trace, 16, bus=EventBus(), engine=TREF).run(
            policy_id=0, fast=True)


# ----------------------------------------------------------------------
# The grid.
# ----------------------------------------------------------------------

def _three_scenarios(wl, max_jobs=MAX_JOBS):
    traces = [
        wl.poisson_trace(20, 16, 5.0, (1, 12), (30.0, 300.0), seed=0),
        wl.poisson_trace(14, 24, 7.0, (1, 16), (60.0, 600.0), seed=1),
        wl.bursty_trace(26, 32, 4.0, (1, 20), (30.0, 400.0), seed=2),
    ]
    return traces, wl.stack_scenarios(traces, [16, 24, 32],
                                      max_jobs=max_jobs)


def test_replay_grid_matches_single_replays_and_jax():
    traces, scen = _three_scenarios(twl)
    grid = TREF.replay_grid(scen, T_IDS)
    assert grid.start_t.shape == (3, len(EXTENDED_POOL), MAX_JOBS)
    for s, (trace, tn) in enumerate(zip(traces, [16, 24, 32])):
        single = TREF.replay(twl.make_scenario(trace, tn,
                                               max_jobs=MAX_JOBS), T_IDS)
        for name in ("start_t", "end_t", "events", "deadlocked"):
            assert torch.equal(getattr(grid, name)[s],
                               getattr(single, name)), f"{s} {name}"
    jgrid = JREF.replay_grid(_three_scenarios(jwl)[1], J_IDS)
    assert_same_outcome(grid, jgrid, "grid")
    util = grid.metrics.utilization.numpy()
    assert util.shape == (3, len(EXTENDED_POOL))
    assert np.all(util > 0) and np.all(util <= 1)


def test_padding_changes_nothing():
    """Padding slots (J=64 vs 128) and inert padding rows
    (``pad_scenarios``) leave every real fork's result unchanged."""
    trace = twl.poisson_trace(16, 16, 5.0, (1, 12), (30.0, 300.0), seed=9)
    a = TREF.replay(twl.make_scenario(trace, 16, max_jobs=64), T_IDS)
    b = TREF.replay(twl.make_scenario(trace, 16, max_jobs=128), T_IDS)
    n = len(trace)
    assert torch.equal(a.start_t[:, :n], b.start_t[:, :n])
    assert torch.equal(a.end_t[:, :n], b.end_t[:, :n])
    assert torch.equal(a.events, b.events)
    assert int(a.result.iters) == int(b.result.iters)

    _, scen = _three_scenarios(twl)
    padded = twl.pad_scenarios(scen, 4)
    assert padded.n_scenarios == 4 and padded.total_nodes[3] == 1
    g = TREF.replay_grid(scen, T_IDS)
    gp = TREF.replay_grid(padded, T_IDS)
    for name in ("start_t", "end_t", "events", "deadlocked", "costs",
                 "best"):
        assert torch.equal(getattr(gp, name)[:3], getattr(g, name)), name
    assert not gp.deadlocked[3].any() and not gp.events[3].any()
    assert int(gp.result.iters) == int(g.result.iters)
    assert int(gp.result.pass_invocations) == \
        int(g.result.pass_invocations)


def test_deadlock_freezes_only_its_scenario():
    good = twl.poisson_trace(12, 16, 5.0, (1, 12), (30.0, 200.0), seed=3)
    bad = [twl.JobSpec(0, 0.0, 4, 60.0, 50.0, "ok"),
           twl.JobSpec(1, 5.0, 64, 60.0, 50.0, "too-big"),   # > 16 nodes
           twl.JobSpec(2, 10.0, 4, 60.0, 50.0, "ok")]
    scen = twl.stack_scenarios([good, bad], 16, max_jobs=32)
    grid = TREF.replay_grid(scen, T_IDS)
    P = len(EXTENDED_POOL)
    assert not grid.deadlocked[0].any() and grid.deadlocked[1].all()
    jstate = grid.result.state.jobs.state.reshape(2, P, 32)
    assert (jstate[1][:, [0, 2]] == DONE).all()
    assert (jstate[1][:, 1] == QUEUED).all()
    assert torch.isinf(grid.costs[1]).all()
    solo = TREF.replay(twl.make_scenario(good, 16, max_jobs=32), T_IDS)
    assert torch.equal(grid.start_t[0], solo.start_t)
    jscen = jwl.stack_scenarios(
        [[jwl.JobSpec(**dataclasses.asdict(j)) for j in t]
         for t in (good, bad)], 16, max_jobs=32)
    assert_same_outcome(grid, JREF.replay_grid(jscen, J_IDS), "deadlock")


def test_stack_scenarios_validates_and_replay_takes_one_scenario():
    J = twl.JobSpec
    t = [J(0, 10.0, 1, 30.0, 20.0, ""), J(1, 5.0, 1, 30.0, 20.0, "")]
    with pytest.raises(ValueError, match="submission order"):
        twl.stack_scenarios([t], 16)
    perm = [J(1, 0.0, 1, 30.0, 20.0, ""), J(0, 0.0, 1, 30.0, 20.0, "")]
    with pytest.raises(ValueError, match="job_id"):
        twl.stack_scenarios([perm], 16)
    with pytest.raises(ValueError, match="total_nodes"):
        twl.stack_scenarios([t[:1]], [16, 32])
    with pytest.raises(ValueError, match="at least one"):
        twl.stack_scenarios([], 16)
    with pytest.raises(ValueError, match="jobs > 1"):
        twl.stack_scenarios([t[:1], t], 16, max_jobs=1)
    scen = twl.stack_scenarios(random_traces(twl, 2, n_jobs=6), 16,
                               max_jobs=32)
    with pytest.raises(ValueError, match="replay_grid"):
        TREF.replay(scen, T_IDS)
    with pytest.raises(ValueError, match="multiple"):
        twl.pad_scenarios(scen, 0)


# ----------------------------------------------------------------------
# Compaction knobs and the block of iterations.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _knob_grid():
    return _three_scenarios(twl)[1], tparse("extended,wfp:a=1..3x3").spec


@functools.lru_cache(maxsize=None)
def _jax_knob_passes(elide_empty):
    scen = _three_scenarios(jwl)[1]
    out = JEngine("reference", elide_empty=elide_empty).replay_grid(
        scen, jparse("extended,wfp:a=1..3x3").spec)
    return int(out.result.iters), int(out.result.pass_invocations)


@pytest.mark.parametrize("elide_empty", [True, False])
@pytest.mark.parametrize("hoist_static", [True, False])
@pytest.mark.parametrize("dynamic_bounds", [True, False])
def test_compaction_knobs_give_the_same_bits(dynamic_bounds, hoist_static,
                                             elide_empty):
    """Every knob combination equals the default engine bitwise; the
    pass count equals the JAX engine's under the same ``elide_empty``
    (it skips passes where no live fork has a queued job)."""
    scen, pool = _knob_grid()
    base = TREF.replay_grid(scen, pool)
    out = TEngine("reference", device="cpu", dynamic_bounds=dynamic_bounds,
                  hoist_static=hoist_static,
                  elide_empty=elide_empty).replay_grid(scen, pool)
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        assert torch.equal(getattr(out, name), getattr(base, name)), name
    iters, passes = _jax_knob_passes(elide_empty)
    assert int(out.result.iters) == iters
    assert int(out.result.pass_invocations) == passes
    assert (passes < iters) == elide_empty


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_block_size_changes_nothing(corpus, monkeypatch):
    """Blocks of 1, 5 and the default: every field identical, ``iters``
    and ``pass_invocations`` included (the body is a no-op once the
    condition is down, and ``it`` counts only steps where it held)."""
    traces = CORPORA[corpus](twl)
    scen = twl.stack_scenarios(traces, 16, max_jobs=MAX_JOBS)
    base = TREF.replay_grid(scen, T_IDS)
    assert corpus == "ties" or int(base.result.iters) > des.REPLAY_BLOCK
    for n in (1, 5):
        monkeypatch.setattr(des, "REPLAY_BLOCK", n)
        assert_same_port_outcome(TREF.replay_grid(scen, T_IDS), base,
                                 f"{corpus} block {n}")


def test_loop_never_runs_past_its_bound(monkeypatch):
    """A full table (32 jobs, J=32) needs 64 iterations; with blocks of
    7 the host runs 63 steps, finds work left, and runs a last block cut
    to the bound 2·J + 2 = 66, never past it.  ``iters`` counts the 64
    steps where the condition held, as the reference's does."""
    trace = twl.poisson_trace(32, 8, 1.0, (1, 8), (30.0, 300.0), seed=4)
    scen = twl.make_scenario(trace, 8, max_jobs=32)
    steps = []
    real = des.make_replay_step

    def counting(*a, **k):
        step = real(*a, **k)
        return lambda c: (steps.append(1), step(c))[1]
    monkeypatch.setattr(des, "make_replay_step", counting)
    monkeypatch.setattr(des, "REPLAY_BLOCK", 7)
    out = TREF.replay(scen, T_IDS[:1])
    jout = JREF.replay(jwl.make_scenario(
        [jwl.JobSpec(**dataclasses.asdict(j)) for j in trace], 8,
        max_jobs=32), J_IDS[:1])
    assert int(out.result.iters) == int(jout.result.iters) == 64
    assert len(steps) == 66
    np.testing.assert_array_equal(out.start_t.numpy(),
                                  np.asarray(jout.start_t))


# ----------------------------------------------------------------------
# Selection under administrator goals.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _goal_grids(goal):
    cfg = dict(scenarios=6, trace="bursty", n_jobs=24, total_nodes=16,
               pool="extended,wfp:a=1..3x3", objective=goal, seed=4)
    jc = JGridConfig(**cfg, backend="reference")
    tc = TGridConfig(**cfg, backend="reference", device="cpu")
    j = JREF.replay_grid(jc.make_scenarios(), jc.make_pool().spec,
                         jc.make_objective())
    t = TREF.replay_grid(tc.make_scenarios(), tc.make_pool().spec,
                         tc.make_objective())
    return j, t


def _near_tied(j, t, s):
    """Forks of scenario s whose metric equals another fork's in one
    package and not in the other while within RTOL."""
    out = set()
    for name, tv in t.metrics._asdict().items():
        a = np.asarray(getattr(j.metrics, name))[s]
        b = tv[s].numpy()
        close = np.isclose(a[:, None], a[None, :], rtol=RTOL)
        split = (a[:, None] == a[None, :]) != (b[:, None] == b[None, :])
        out.update(np.nonzero((close & split).any(1))[0].tolist())
    return out


@pytest.mark.parametrize("goal", ["score", "avg_wait",
                                  "lex:avg_wait,makespan",
                                  "min:avg_wait@util>=0.85"])
def test_grid_select_matches_jax(goal):
    j, t = _goal_grids(goal)
    for name in ("start_t", "end_t", "deadlocked", "events"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    elementwise = parse_objective(goal).elementwise
    jc, tc = np.asarray(j.costs), t.costs.numpy()
    jb, tb = np.asarray(j.best), t.best.numpy()
    flips = []
    for s in range(jc.shape[0]):
        near = set() if elementwise else _near_tied(j, t, s)
        if jb[s] != tb[s]:
            if (np.isclose(jc[s, jb[s]], tc[s, tb[s]], rtol=RTOL)
                    or {int(jb[s]), int(tb[s])} <= near):
                flips.append((s, int(jb[s]), int(tb[s])))
                continue
            raise AssertionError(f"{goal} scenario {s}: {tb[s]} != {jb[s]}")
        if elementwise:
            np.testing.assert_allclose(tc[s], jc[s], rtol=RTOL)
        else:
            keep = [p for p in range(jc.shape[1]) if p not in near]
            np.testing.assert_array_equal(tc[s, keep], jc[s, keep])
    assert not flips, f"near-tie winner flips: {flips}"


# ----------------------------------------------------------------------
# Workload tools and configs, bitwise against JAX's arrays.
# ----------------------------------------------------------------------

def _assert_sets_equal(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_workload_tools_match_jax(tmp_path):
    tt, jt = random_traces(twl, 3), random_traces(jwl, 3)
    t, j = (twl.stack_scenarios(tt, [16, 24, 32]),
            jwl.stack_scenarios(jt, [16, 24, 32]))
    _assert_sets_equal(t, j)
    _assert_sets_equal(twl.slice_scenarios(t, 1, 3),
                       jwl.slice_scenarios(j, 1, 3))
    _assert_sets_equal(twl.pad_scenarios(t, 5), jwl.pad_scenarios(j, 5))
    _assert_sets_equal(twl.make_scenario(tt[0], 16, max_jobs=32),
                       jwl.make_scenario(jt[0], 16, max_jobs=32))
    split = lambda wl: wl.split_scenarios(                  # noqa: E731
        np.random.default_rng(3),
        lambda r: wl.poisson_trace(10, 16, 8.0, (1, 16), (30.0, 900.0),
                                   rng=r), 3, 2, 16)
    for a, b in zip(split(twl), split(jwl)):
        _assert_sets_equal(a, b)
    for key, v in twl.trace_to_arrays(tt[1]).items():
        np.testing.assert_array_equal(v, jwl.trace_to_arrays(jt[1])[key])
    assert twl.trace_stats(tt[2]) == jwl.trace_stats(jt[2])
    twl.write_swf(tt[0], str(tmp_path / "t.swf"))
    jwl.write_swf(jt[0], str(tmp_path / "j.swf"))
    assert (tmp_path / "t.swf").read_text() == (tmp_path / "j.swf").read_text()
    back_t = twl.read_swf(str(tmp_path / "t.swf"), max_jobs=15)
    back_j = jwl.read_swf(str(tmp_path / "t.swf"), max_jobs=15)
    assert [dataclasses.astuple(x) for x in back_t] == [
        dataclasses.astuple(x) for x in back_j]
    assert len(back_t) == 15


@pytest.mark.parametrize("trace", ["poisson", "bursty", "paper"])
def test_replay_grid_config_matches_jax(trace):
    kw = dict(scenarios=3, trace=trace, n_jobs=20, seed=2)
    _assert_sets_equal(TGridConfig(**kw).make_scenarios(),
                       JGridConfig(**kw).make_scenarios())
    assert TGridConfig(**kw).make_pool().names == \
        JGridConfig(**kw).make_pool().names
    assert str(TGridConfig(**kw).make_objective()) == "score"
    eng = TGridConfig(backend="reference", device="cpu").make_engine()
    assert eng.backend == "reference" and eng.device.type == "cpu"


def test_tile_pool_matches_jax():
    from repro.core.engine import tile_pool as jtile
    t = tile_pool(tparse("extended,wfp:a=1..2x2").spec, 3)
    j = jtile(jparse("extended,wfp:a=1..2x2").spec, 3)
    np.testing.assert_array_equal(t.family.numpy(), np.asarray(j.family))
    np.testing.assert_array_equal(t.theta.numpy(), np.asarray(j.theta))
    np.testing.assert_array_equal(tile_pool(T_IDS, 2).numpy(),
                                  np.asarray(jtile(J_IDS, 2)))


# ----------------------------------------------------------------------
# The CLI.
# ----------------------------------------------------------------------

GRID_ARGS = ["--replay-grid", "3", "--trace", "bursty", "--jobs", "16",
             "--nodes", "16", "--pool", "extended", "--seed", "1"]


def _table(text, first="replay grid:"):
    """The grid's table and winners, from the line starting ``first``,
    without the wall time."""
    lines = text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith(first))
    head = lines[start].rsplit(" in ", 1)[0]
    return [head] + lines[start + 1:]


@pytest.mark.parametrize("goal", ["score", "min:avg_wait@util>=0.85"])
def test_twin_loop_replay_grid_matches_reference(goal, capsys, monkeypatch):
    argv = GRID_ARGS + ["--objective", goal]
    tloop.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out
    assert "backend=reference device=cpu" in port
    monkeypatch.setattr(sys, "argv", ["twin_loop", "--no-compile-cache",
                                      "--backend", "reference"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jloop.main()
    assert _table(port) == _table(buf.getvalue())
    assert len(_table(port)) == 2 + len(EXTENDED_POOL) + 1


@pytest.mark.parametrize("flag,item", [(["--fan", "8"], "A7"),
                                       (["--fan", "8", "--race"], "A7"),
                                       (["--shard", "2"], "A8"),
                                       (["--block-size", "4"], "A8"),
                                       (["--prefetch", "0"], "A8")])
def test_twin_loop_refuses_unported_grid_modes(flag, item, capsys,
                                               monkeypatch):
    """No grid mode of the reference CLI is refused any more: the fan
    and raced grids (A7) and the fleet flags (A8) run on the CPU and
    print the reference CLI's table line for line (``--backend
    reference``): the S × F × P grid with its fan confidence line, the
    race's rungs, members, survivors and winners, or the plain grid.
    ``--shard 2`` and ``--block-size 4`` run the sharded, block-streamed
    grid (two host shards, or blocks of 4 scenarios); the reference's
    own sharded entries fail on this jax, so their table is held
    against the reference's one-shot grid, and the first line differs
    only in naming the shards, the block and the prefetch."""
    tloop.main(GRID_ARGS + ["--device", "cpu"] + flag)
    port = capsys.readouterr().out
    assert "not yet ported" not in port
    fleet = item == "A8" and "--prefetch" not in flag
    monkeypatch.setattr(sys, "argv", ["twin_loop", "--no-compile-cache",
                                      "--backend", "reference"]
                        + GRID_ARGS + ([] if fleet else flag))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jloop.main()
    head = "raced grid:" if "--race" in flag else "replay grid:"
    got, want = _table(port, head), _table(buf.getvalue(), head)
    assert head in port
    if fleet:
        shards = 2 if "--shard" in flag else 1
        block = 4 if "--block-size" in flag else "whole set"
        want[0] = want[0].replace(
            "one device computation",
            f"{shards} shard(s), block={block}, prefetch=2")
    assert got == want


@pytest.mark.parametrize("flag", [
    ["--fan", "8", "--prune"],
    ["--fan", "8", "--prune", "--fan-fail", "0.3", "--objective",
     "cvar:0.9:score"],
    ["--fan", "6", "--fan-noise", "0.5", "--fan-burst", "0.3",
     "--fan-seed", "4", "--objective", "p95:avg_wait"],
    ["--fan", "16", "--race", "--race-f0", "4", "--fan-fail", "0.2"]],
    ids=["prune", "prune_cvar_fail", "burst", "race_f0"])
def test_twin_loop_fan_grid_modes_match_reference(flag, capsys,
                                                   monkeypatch):
    """``--prune`` and the other --fan*/--race* flags of the grid: the
    reference CLI's table, line for line."""
    tloop.main(GRID_ARGS + ["--device", "cpu"] + flag)
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["twin_loop", "--no-compile-cache",
                                      "--backend", "reference"]
                        + GRID_ARGS + flag)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jloop.main()
    head = "raced grid:" if "--race" in flag else "replay grid:"
    assert _table(port, head) == _table(buf.getvalue(), head)
    if "--prune" in flag:
        assert "prune: pre-pass" in port


@pytest.mark.parametrize("flag", [["--prune"], ["--race"],
                                  ["--race-f0", "4"],
                                  ["--fan", "4", "--race", "--prune"],
                                  ["--fan", "4", "--ensemble", "2"]])
def test_twin_loop_fan_flag_combinations(flag, capsys):
    """The reference's refusals of --fan/--race/--prune combinations."""
    with pytest.raises(SystemExit) as exc:
        tloop.main(GRID_ARGS + ["--device", "cpu"] + flag)
    assert exc.value.code == 2


@pytest.mark.parametrize("flag", [["--failures", "1"], ["--budget-s", "1"]])
def test_twin_loop_replay_grid_flag_combinations(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tloop.main(GRID_ARGS + ["--device", "cpu"] + flag)
    assert exc.value.code == 2
    assert "--replay-grid" in capsys.readouterr().err
