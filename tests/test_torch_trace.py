"""The port's span and counter recorder (``core.telemetry.SpanRecorder``)
and what the replay records into it, on the CPU at smoke sizes.

* the span tree under a fake clock: roots, parents, one id per root,
  self time; counters on the open root; threads' own stacks; the bounded
  record of roots;
* a tiny ``replay_grid``: one ``grid`` root over ``replay`` (a
  ``replay.read`` a block), and the counters against ``ReplayResult``;
* the profiler: no range is entered while none records; under a CPU
  ``torch.profiler`` the span and phase names are among the host
  events, and the grid's outputs are bitwise those of an unprofiled run;
* a twin's decision cycles under a fan: one ``decision`` root a cycle
  over a ``drain`` with one ``drain.read`` an iteration, ``drain.steps``
  against the drain's ``pass_invocations``, a drain outside a decision
  as a root of its own, and the decisions bitwise the same without the
  recorder and under a profiler;
* ``Telemetry.cycle_latency_stats``: a true median and a p95 (C18).
"""
import contextlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.cluster.workload import poisson_trace, stack_scenarios
from repro_torch.core import des, telemetry
from repro_torch.core.engine import DrainEngine
from repro_torch.core.policies import normalize_pool
from repro_torch.core.telemetry import (CycleRecord, SpanRecorder,
                                        Telemetry)

from torch_threads import one_thread  # noqa: F401

SPAN_NAMES = {"grid", "replay", "replay.read"}
DRAIN_NAMES = {"decision", "drain", "drain.read"}
PHASE_NAMES = {"replay.event", "replay.apply", "replay.order",
               "replay.pass", "replay.starts"}


class Clock:
    """A clock (ns) that moves only when told."""

    def __init__(self) -> None:
        self.t = 0

    def __call__(self) -> int:
        return self.t


@pytest.fixture
def rec(monkeypatch):
    """A fresh process recorder, so one test's roots are not another's."""
    r = SpanRecorder()
    monkeypatch.setattr(telemetry, "SPANS", r)
    return r


def _scenarios(n_jobs=20, max_jobs=None, S=2):
    traces = [poisson_trace(n_jobs, 16, 30.0, (1, 4), (60.0, 600.0),
                            seed=s) for s in range(S)]
    return stack_scenarios(traces, 16, max_jobs)


def _grid(scen=None):
    return DrainEngine(device="cpu").replay_grid(
        _scenarios() if scen is None else scen, normalize_pool("paper").spec)


def test_span_tree_under_a_fake_clock():
    clock = Clock()
    rec = SpanRecorder(clock=clock)
    with rec.span("grid"):                         # 0 .. 90
        clock.t = 10
        with rec.span("prep"):                     # 10 .. 20
            clock.t = 20
        clock.t = 30
        with rec.span("replay"):                   # 30 .. 80
            for t in (40, 60):
                clock.t = t
                with rec.span("replay.read"):      # 40 .. 50, 60 .. 70
                    clock.t = t + 10
            clock.t = 80
            rec.count("replay.steps", 64)
            rec.count("replay.iters", torch.tensor(60, dtype=torch.int32))
        clock.t = 90
    clock.t = 100
    with rec.span("grid"):
        clock.t = 130
    rec.count("replay.steps", 7)                   # no span open: dropped

    first, second = list(rec.roots)
    root = first.root
    assert [s.name for s in first.spans] == ["grid", "prep",
                                             "replay", "replay.read",
                                             "replay.read"]
    assert root.parent is None and root.id == root.root
    assert {s.root for s in first.spans} == {root.id}
    (replay,) = first.named("replay")
    assert [s.parent for s in first.spans[1:]] == [root.id, root.id,
                                                   replay.id, replay.id]
    assert first.children(replay) == first.named("replay.read")
    assert (root.ns, replay.ns) == (90, 50)
    assert first.self_ns(replay) == 30 and first.self_ns(root) == 30
    assert isinstance(first.counters["replay.iters"][0], torch.Tensor)
    assert first.counts() == {"replay.steps": 64, "replay.iters": 60}
    assert second.root.id != root.id and second.root.ns == 30
    assert second.counts() == {}
    ids = [s.id for t in (first, second) for s in t.spans]
    assert len(set(ids)) == len(ids)


def test_record_keeps_the_last_roots():
    rec = SpanRecorder(keep=3)
    for i in range(5):
        with rec.span(f"r{i}"):
            with rec.span("child"):
                pass
    assert [t.root.name for t in list(rec.roots)] == ["r2", "r3", "r4"]
    assert all(len(t.spans) == 2 for t in list(rec.roots))


def test_threads_keep_their_own_stacks():
    rec = SpanRecorder()
    done = threading.Event()

    def worker():
        with rec.span("prefetch"):
            rec.count("blocks", 1)
        done.set()

    with rec.span("grid"):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        rec.count("blocks", 2)
    assert done.is_set() and not th.is_alive()
    trees = {t.root.name: t for t in list(rec.roots)}
    assert set(trees) == {"prefetch", "grid"}
    assert len(trees["grid"].spans) == 1
    assert trees["prefetch"].counts() == {"blocks": 1}
    assert trees["grid"].counts() == {"blocks": 2}


@pytest.mark.parametrize("max_jobs", [4, None])
def test_replay_grid_counters(rec, max_jobs):
    """``replay.steps`` is whole blocks or the 2·J + 2 cap, one read a
    block, and the device counts are ``ReplayResult``'s."""
    n_jobs = 4 if max_jobs else 20
    scen = _scenarios(n_jobs, max_jobs)
    out = _grid(scen)
    stack, tree = list(rec.roots)
    assert (stack.root.name, tree.root.name) == ("stack", "grid")
    assert {s.name for s in tree.spans} == SPAN_NAMES
    assert [s.name for s in tree.children(tree.root)] == ["replay"]
    (replay,) = tree.named("replay")
    reads = tree.children(replay)
    assert {s.name for s in reads} == {"replay.read"}
    counts = tree.counts()
    J = scen.valid.shape[1]
    assert (counts["replay.steps"] % des.REPLAY_BLOCK == 0
            or counts["replay.steps"] == 2 * J + 2)
    assert len(reads) == -(-counts["replay.steps"] // des.REPLAY_BLOCK)
    assert counts["replay.iters"] == int(out.result.iters)
    assert counts["replay.iters"] <= counts["replay.steps"]
    assert tree.self_ns(replay) + sum(r.ns for r in reads) == replay.ns


def test_no_profiler_range_without_a_profiler(rec, monkeypatch):
    entered = []

    class Counted:
        def __init__(self, name, *a, **kw):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counted)
    _grid()
    assert not telemetry.profiling()
    assert entered == []
    assert [t.root.name for t in list(rec.roots)] == ["stack", "grid"]


def test_names_in_a_cpu_profile_and_outputs_unchanged(rec):
    scen = _scenarios()
    plain = _grid(scen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _grid(scen)
    names = {e.name for e in prof.events()}
    assert SPAN_NAMES | PHASE_NAMES <= names
    for field in ("start_t", "end_t", "deadlocked", "events", "costs",
                  "best"):
        assert torch.equal(getattr(plain, field), getattr(traced, field))
    for a, b in zip(plain.metrics, traced.metrics):
        assert torch.equal(a, b)
    assert torch.equal(plain.result.iters, traced.result.iters)
    first, second = [t.counts() for t in list(rec.roots)
                     if t.root.name == "grid"]
    assert first == second


def test_span_opened_before_the_profiler_shows_from_its_start(rec):
    """A profiler started inside a grid (as a window inside a unit is)
    carries the open spans' names from the first phase under them."""
    got = []
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: got.extend(
                       e.name for e in p.events()))
    with telemetry.SPANS.span("grid"):
        with telemetry.SPANS.span("replay"):
            prof.start()
            with telemetry.SPANS.phase("replay.event"):
                torch.ones(3).sum()             # warm-up: not recording
            prof.step()
            with telemetry.SPANS.phase("replay.event"):
                torch.ones(3).sum()
            prof.step()
            prof.stop()
        with telemetry.SPANS.phase("replay.pass"):    # recording ended
            torch.ones(3).sum()
    assert {"grid", "replay", "replay.event"} <= set(got)
    assert "replay.pass" not in got
    assert list(rec.roots)[0].root.name == "grid"


class NoRecorder:
    """A recorder that records nothing: the program without its spans."""

    def span(self, name):
        return contextlib.nullcontext()

    def count(self, name, value):
        pass

    def phase(self, name):
        return contextlib.nullcontext()


def _cosim(drains=None):
    """A fan twin (4 futures, the paper's pool, CVaR) co-simulated with
    the emulator on the CPU; ``drains`` collects each decision drain's
    ``DrainResult``."""
    from repro_torch.cluster.emulator import ClusterEmulator
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.events import EventBus
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.twin import SchedTwin
    trace = poisson_trace(16, 16, 20.0, (1, 6), (60.0, 900.0), seed=2)
    engine = DrainEngine(device="cpu")
    bus = EventBus()
    em = ClusterEmulator(trace, 16, bus=bus, engine=engine)
    twin = SchedTwin(bus=bus, qrun=em.qrun, total_nodes=16,
                     max_jobs=em.max_jobs, engine=engine, device="cpu",
                     fan=FanSpec(n=4, runtime_noise=0.3, failure_prob=0.5,
                                 seed=9), objective="cvar:0.5:score",
                     free_nodes_probe=lambda: em.free_nodes)
    drain = engine_mod.simulate_to_drain_batched

    def recorded(*a, **kw):
        res = drain(*a, **kw)
        if drains is not None:
            drains.append(res)
        return res
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "simulate_to_drain_batched", recorded)
        report = em.run(on_event=twin.pump)
    return twin, report


def _decisions(twin):
    return [(c.time, c.policy, c.started_jobs, c.costs, c.cost_ci,
             c.fan_width, c.term_costs) for c in twin.telemetry.cycles]


def test_decision_and_drain_spans(rec):
    drains = []
    twin, _ = _cosim(drains)
    cycles = twin.telemetry.cycles
    trees = [t for t in list(rec.roots) if t.root.name == "decision"]
    assert len(trees) == len(cycles) == len(drains) > 2
    for tree, cyc, res in zip(trees, cycles, drains):
        assert {s.name for s in tree.spans} == DRAIN_NAMES
        (drain,) = tree.named("drain")
        assert tree.children(tree.root) == [drain]
        reads = tree.children(drain)
        assert reads == tree.named("drain.read")
        steps = tree.counts()["drain.steps"]
        assert steps == int(res.pass_invocations[0])
        assert len(reads) == steps + 1       # and the read that ends it
        assert tree.self_ns(drain) + sum(r.ns for r in reads) == drain.ns
        assert tree.root.ns >= 1e9 * cyc.wall_seconds - 1e3
    assert sum(t.counts()["drain.steps"] > 0 for t in trees) > 2
    # the emulator's own drains are roots of their own
    assert all(t.root.name in ("decision", "drain", "stack", "grid",
                               "replay") for t in list(rec.roots))


def test_drain_outside_a_decision_is_a_root(rec):
    from repro_torch.core import sync
    from repro_torch.core.events import Event, EventKind
    from repro_torch.core.state import empty_state
    st = empty_state(16, 16, device="cpu")
    for j in range(6):
        st, _ = sync.apply_event(st, Event(
            EventKind.QUEUEJOB, float(j), j,
            {"nodes": float(4 + j), "est_runtime": 100.0 * (j + 1)}))
    res = DrainEngine(device="cpu").drain(st, normalize_pool("paper").spec)
    (tree,) = list(rec.roots)
    assert tree.root.name == "drain" and tree.root.parent is None
    steps = int(res.pass_invocations[0])
    assert tree.counts() == {"drain.steps": steps} and steps > 1
    assert len(tree.named("drain.read")) == steps + 1


@pytest.mark.parametrize("how", ["no recorder", "profiler"])
def test_decisions_unchanged_by_the_recorder(rec, monkeypatch, how):
    plain, plain_report = _cosim()
    if how == "no recorder":
        monkeypatch.setattr(telemetry, "SPANS", NoRecorder())
        other, other_report = _cosim()
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            other, other_report = _cosim()
        assert DRAIN_NAMES <= {e.name for e in prof.events()}
    assert _decisions(other) == _decisions(plain)
    assert other_report.metric_dict() == plain_report.metric_dict()


def _cycles(walls):
    tel = Telemetry()
    for i, w in enumerate(walls):
        tel.record(CycleRecord(time=float(i), wall_seconds=w, policy="fcfs",
                               costs={}, n_started=0, started_jobs=[]))
    return tel


@pytest.mark.parametrize("walls, p50, p95", [
    ([4.0, 1.0, 3.0, 2.0], 2.5, 4.0),              # even n: middle mean
    ([5.0, 1.0, 3.0], 3.0, 5.0),                   # odd n
    ([float(i) for i in range(20, 0, -1)], 10.5, 19.0),
])
def test_cycle_latency_median_and_p95(walls, p50, p95):
    lat = _cycles(walls).cycle_latency_stats()
    assert lat["p50_s"] == p50 and lat["p95_s"] == p95
    assert lat["n"] == len(walls) and lat["max_s"] == max(walls)
    assert Telemetry().cycle_latency_stats()["p95_s"] == 0.0
