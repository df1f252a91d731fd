"""The twin's Monte-Carlo decision modes end to end: co-simulations of
the port's ``SchedTwin`` against the JAX package's, on the CPU.

The verify recipe's co-simulation (``--trace poisson --jobs 30 --nodes
16 --seed 3``, paper pool) with ``ensemble=4`` (clean, with a node
failure, and under a deadline guard held at ladder level 1, where the
ensemble shrinks to 2 members and the twin's threefry key is still
split before every decision), with a small fan (noise, failures over
two domains, ``p95:avg_wait``) and with a race (F₀=2 → 8,
``cvar:0.9:score``); both twins on the ``reference`` engine.

Tolerances: the ``RunReport`` metric table rtol 1e-6; the policy mix
and every cycle's winner, started jobs, time, fan size, guard level and
race accounting identical; every cycle's costs rtol 1e-5 (ROADMAP C4).
"""
import dataclasses

import numpy as np
import pytest

from repro.cluster import workload as jwl
from repro.cluster.emulator import ClusterEmulator as JEmulator
from repro.core import fan as jfan
from repro.core import race as jrace
from repro.core.engine import DrainEngine as JEngine
from repro.core.events import EventBus as JBus
from repro.core.guard import GuardSpec as JGuardSpec
from repro.core.twin import SchedTwin as JTwin
from repro_torch.cluster.emulator import ClusterEmulator as TEmulator
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.events import EventBus as TBus
from repro_torch.core.fan import FanSpec
from repro_torch.core.guard import GuardSpec as TGuardSpec
from repro_torch.core.race import RaceSpec
from repro_torch.core.twin import SchedTwin as TTwin
from repro_torch.launch import twin_loop as tloop

RTOL = 1e-5
TREF = TEngine("reference", device="cpu")
JREF = JEngine("reference")

ARGS = ["--trace", "poisson", "--jobs", "30", "--nodes", "16", "--seed", "3"]


def _ticking_clock():
    t = [0.0]

    def clock():
        t[0] += 10.0
        return t[0]
    return clock


def _cosim_pair(jkw, tkw, failures=0):
    """One co-simulation per package over the same trace and failures,
    the twins built with ``jkw``/``tkw``."""
    args = tloop.build_parser().parse_args(
        ARGS + ["--failures", str(failures), "--device", "cpu"])
    trace = tloop.make_trace(args)
    fails = tloop.make_failures(args, trace)
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from repro.cluster.emulator import FailureSpec
            tr = [jwl.JobSpec(**dataclasses.asdict(j)) for j in trace]
            fl = [FailureSpec(f.time, f.nodes, f.duration) for f in fails]
            bus = JBus()
            em = JEmulator(tr, args.nodes, bus=bus, failures=fl,
                           check_invariants=True, engine=JREF)
            twin = JTwin(bus=bus, qrun=em.qrun, total_nodes=args.nodes,
                         max_jobs=em.max_jobs, engine=JREF,
                         free_nodes_probe=lambda em=em: em.free_nodes,
                         jobs_probe=em.jobs_view, **jkw)
        else:
            bus = TBus()
            em = TEmulator(trace, args.nodes, bus=bus, failures=fails,
                           check_invariants=True, engine=TREF)
            twin = TTwin(bus=bus, qrun=em.qrun, total_nodes=args.nodes,
                         max_jobs=em.max_jobs, engine=TREF,
                         free_nodes_probe=lambda em=em: em.free_nodes,
                         jobs_probe=em.jobs_view, **tkw)
        goal = jkw.get("objective")
        rep = em.run(on_event=twin.pump, objective=goal,
                     on_quiesce=twin.flush)
        out.append((rep, twin))
    return out


def _assert_cosims_match(pair):
    (jrep, jtwin), (trep, ttwin) = pair
    jm, tm = jrep.metric_dict(), trep.metric_dict()
    assert list(tm) == list(jm)
    np.testing.assert_allclose([tm[k] for k in tm], [jm[k] for k in jm],
                               rtol=1e-6)
    assert (ttwin.telemetry.policy_start_distribution()
            == jtwin.telemetry.policy_start_distribution())
    jc, tc = jtwin.telemetry.cycles, ttwin.telemetry.cycles
    assert len(tc) == len(jc) > 0
    for i, (a, b) in enumerate(zip(tc, jc)):
        assert (a.policy, a.started_jobs, a.time, a.fan_size,
                a.guard_level, a.race_rungs, a.race_members,
                a.race_stopped) == (b.policy, b.started_jobs, b.time,
                                    b.fan_size, b.guard_level,
                                    b.race_rungs, b.race_members,
                                    b.race_stopped), f"cycle {i}"
        assert list(a.cost_ci) == list(b.cost_ci)
        np.testing.assert_allclose(list(a.costs.values()),
                                   list(b.costs.values()), rtol=RTOL)
    return jc


@pytest.mark.parametrize("failures", [0, 1])
def test_cosimulation_ensemble4_matches_reference(failures):
    pair = _cosim_pair(dict(ensemble=4, seed=2), dict(ensemble=4, seed=2),
                       failures)
    cycles = _assert_cosims_match(pair)
    assert all(c.fan_size == 4 for c in cycles)


def test_cosimulation_ensemble_shrunk_at_level1_matches_reference():
    """A guard whose clock says every cycle blew its budget, capped at
    level 1: after the first cycle the ensemble shrinks to 2 members,
    and the key is split before every decision on both sides."""
    pair = _cosim_pair(
        dict(ensemble=4, guard=JGuardSpec(budget_s=1.0, max_level=1),
             clock=_ticking_clock()),
        dict(ensemble=4, guard=TGuardSpec(budget_s=1.0, max_level=1),
             clock=_ticking_clock()))
    cycles = _assert_cosims_match(pair)
    assert {c.fan_size for c in cycles} == {4, 2}


def test_cosimulation_fan_matches_reference():
    kw = dict(n=4, runtime_noise=0.3, failure_prob=0.2,
              failure_domains=2, seed=1)
    pair = _cosim_pair(
        dict(fan=jfan.FanSpec(**kw), objective="p95:avg_wait"),
        dict(fan=FanSpec(**kw), objective="p95:avg_wait"), failures=1)
    cycles = _assert_cosims_match(pair)
    assert all(c.fan_size == 4 for c in cycles)


def test_cosimulation_race_matches_reference():
    kw = dict(n=8, runtime_noise=0.3, seed=2)
    pair = _cosim_pair(
        dict(race=jrace.RaceSpec(fan=jfan.FanSpec(**kw), f0=2),
             objective="cvar:0.9:score"),
        dict(race=RaceSpec(fan=FanSpec(**kw), f0=2),
             objective="cvar:0.9:score"))
    cycles = _assert_cosims_match(pair)
    assert all(c.race_rungs >= 1 for c in cycles)
