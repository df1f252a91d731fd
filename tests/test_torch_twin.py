"""The slice end to end: the twin/emulator co-simulation of both packages.

The run of the verify recipe (``--trace poisson --jobs 30 --nodes 16
--seed 3``, paper pool, goal ``score``), once clean and once with
``--failures 1``, goes through the JAX package's ``twin_loop`` machinery
(``ClusterEmulator`` + ``SchedTwin`` on the ``reference`` engine, as its
``main`` builds them) and through the port's ``twin_loop.co_simulate`` on
the CPU.

Tolerances:
  * the ``RunReport`` metric table: ``rtol=1e-6`` (host f64 arithmetic
    over identical schedules; in practice equal);
  * policy mix and every cycle's winner and started-job list: identical;
  * the port's trace generators: identical ``JobSpec`` lists;
  * the sync handlers on one event stream: mirrors bitwise equal;
  * the emulator's static mode: identical start times, report rtol 1e-6.
"""
import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest

from repro.cluster import workload as jwl
from repro.cluster.emulator import ClusterEmulator
from repro.core import state as jstate
from repro.core import sync as jsync
from repro.core.engine import DrainEngine
from repro.core.events import Event as JEvent
from repro.core.events import EventBus
from repro.core.events import EventKind as JKind
from repro.core.policies import parse_pool as jparse
from repro.core.twin import SchedTwin
from repro.launch import twin_loop as jloop
from repro_torch.cluster import workload as twl
from repro_torch.cluster.emulator import ClusterEmulator as TEmulator
from repro_torch.convert import state_to_numpy
from repro_torch.core import state as tstate
from repro_torch.core import sync as tsync
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.events import Event as TEvent
from repro_torch.core.events import EventKind as TKind
from repro_torch.core.policies import parse_pool as tparse
from repro_torch.launch import twin_loop as tloop
from torch_threads import one_thread  # noqa: F401


ARGS = ["--trace", "poisson", "--jobs", "30", "--nodes", "16", "--seed", "3"]


def _jax_cosim(argv):
    """What ``repro.launch.twin_loop.main`` builds for the co-simulation
    (reference backend), returning the report and the twin."""
    args = tloop.build_parser().parse_args(argv)   # same flag meanings
    trace = tloop.make_trace(args)
    failures = [jloop.FailureSpec(f.time, f.nodes, f.duration)
                for f in tloop.make_failures(args, trace)]
    jtrace = [jwl.JobSpec(**dataclasses.asdict(j)) for j in trace]
    engine = DrainEngine(backend="reference")
    bus = EventBus()
    em = ClusterEmulator(jtrace, args.nodes, bus=bus, failures=failures,
                         check_invariants=True, engine=engine)
    twin = SchedTwin(bus=bus, qrun=em.qrun, total_nodes=args.nodes,
                     max_jobs=em.max_jobs, pool=args.pool,
                     objective=args.objective,
                     free_nodes_probe=lambda: em.free_nodes,
                     jobs_probe=em.jobs_view, engine=engine)
    report = em.run(on_event=twin.pump, objective=args.objective,
                    on_quiesce=twin.flush)
    return report, twin


@pytest.mark.parametrize("failures", [0, 1])
def test_cosimulation_matches_reference(failures):
    argv = ARGS + ["--failures", str(failures)]
    jrep, jtwin = _jax_cosim(argv)
    trep, ttwin, _ = tloop.co_simulate(
        tloop.build_parser().parse_args(argv + ["--device", "cpu"]))
    jm, tm = jrep.metric_dict(), trep.metric_dict()
    assert list(tm) == list(jm)
    np.testing.assert_allclose([tm[k] for k in tm], [jm[k] for k in jm],
                               rtol=1e-6)
    assert (trep.n_events, trep.n_restarts) == (jrep.n_events,
                                                jrep.n_restarts)
    assert (ttwin.telemetry.policy_start_distribution()
            == jtwin.telemetry.policy_start_distribution())
    jc, tc = jtwin.telemetry.cycles, ttwin.telemetry.cycles
    assert len(tc) == len(jc) > 0
    for i, (a, b) in enumerate(zip(tc, jc)):
        assert (a.policy, a.started_jobs, a.time) == (
            b.policy, b.started_jobs, b.time), f"cycle {i}"
        assert list(a.costs) == list(b.costs)
        np.testing.assert_allclose(list(a.costs.values()),
                                   list(b.costs.values()), rtol=1e-5)
    assert ttwin.telemetry.runtime_residuals == \
        jtwin.telemetry.runtime_residuals


def test_trace_generators_identical():
    for seed in (0, 3, 11):
        assert twl.paper_synthetic_trace(seed=seed) == [
            twl.JobSpec(**dataclasses.asdict(j))
            for j in jwl.paper_synthetic_trace(seed=seed)]
        for name in ("poisson_trace", "bursty_trace"):
            a = getattr(twl, name)(40, 16, 8.0, (1, 16), (30.0, 900.0),
                                   seed=seed)
            b = getattr(jwl, name)(40, 16, 8.0, (1, 16), (30.0, 900.0),
                                   seed=seed)
            assert [dataclasses.astuple(j) for j in a] == [
                dataclasses.astuple(j) for j in b]
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(
            seed)
        a = twl.poisson_trace(10, 560, 4.0, (1, 11), (300.0, 86400.0),
                              rng=rng_a)
        b = jwl.poisson_trace(10, 560, 4.0, (1, 11), (300.0, 86400.0),
                              rng=rng_b)
        assert [dataclasses.astuple(j) for j in a] == [
            dataclasses.astuple(j) for j in b]


def test_twin_loop_main_runs_on_cpu(capsys):
    tloop.main(ARGS + ["--device", "cpu", "--jobs", "12"])
    out = capsys.readouterr().out
    assert "backend=reference device=cpu" in out
    assert "policy mix:" in out and "cycle latency:" in out


#: Modes of the reference CLI that the port runs (the other cases of
#: ``test_twin_loop_rejects_unported_modes`` still refuse).
_TRAIN = ["--train", "2", "--train-pop", "4", "--train-scenarios", "2",
          "--train-heldout", "1"]
_PORTED_MODES = (["--fan", "8"], ["--fan", "8", "--race"],
                 ["--ensemble", "4"], _TRAIN, ["--chaos"],
                 ["--snapshot-dir", "x"])


def _cosim_table(text):
    """A co-simulation's printed report without its first line (the
    port's names the device) and its wall-time line."""
    return [line for line in text.splitlines()[1:]
            if not line.startswith(("cycle latency:", "trained "))]


@pytest.mark.parametrize("flag", [["--replay-grid", "4", "--shard", "2"],
                                  _TRAIN,
                                  ["--fan", "8"], ["--fan", "8", "--race"],
                                  ["--ensemble", "4"], ["--chaos"],
                                  ["--snapshot-dir", "x"]])
def test_twin_loop_rejects_unported_modes(flag, capsys, monkeypatch,
                                          tmp_path):
    """No mode of the reference CLI is refused any more: the fan, race,
    ensemble, training, chaos and snapshot modes run on the CPU and print
    the reference CLI's report (``--backend reference``) line for line:
    the metric table, the what-if breakdown, the policy mix, the fan
    confidence and race lines, resilience, bus health and the chaos
    counts, or the trainer's generations and held-out board (wall times
    aside).  ``--replay-grid 4 --shard 2`` runs the sharded grid on two
    host shards and prints the reference's one-shot grid table (its own
    sharded entry fails on this jax), the first line naming the shards
    in place of "one device computation"."""
    port_flag = [str(tmp_path / "t") if f == "x" else f for f in flag]
    ref_flag = [str(tmp_path / "j") if f == "x" else f for f in flag]
    fleet = flag not in _PORTED_MODES
    if fleet:
        ref_flag = ref_flag[:2]
    tloop.main(ARGS + ["--device", "cpu"] + port_flag)
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["twin_loop", "--no-compile-cache",
                                      "--backend", "reference"]
                        + ARGS + ref_flag)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jloop.main()
    want = _cosim_table(buf.getvalue())
    if fleet:
        want = [line.replace("one device computation",
                             "2 shard(s), block=whole set, prefetch=2")
                for line in want]
        got = [line.rsplit(" in ", 1)[0] if line.startswith("replay grid:")
               else line for line in _cosim_table(port)]
        assert got == [line.rsplit(" in ", 1)[0]
                       if line.startswith("replay grid:") else line
                       for line in want]
        return
    assert _cosim_table(port) == want
    assert ("fan confidence" in port) == (
        "--fan" in flag or "--ensemble" in flag)
    assert ("race:" in port) == ("--race" in flag)
    assert ("chaos injected:" in port) == ("--chaos" in flag)
    assert ("<- trained" in port) == ("--train" in flag)


def _mirror_equal(ts, js, ctx):
    a, b = state_to_numpy(ts), state_to_numpy(js)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{ctx} {key}")
        assert a[key].dtype == b[key].dtype, f"{ctx} {key}"


@pytest.mark.parametrize("idempotent", [False, True])
def test_sync_handlers_match(idempotent):
    """Every handler of ``sync.apply_event`` on the same event stream —
    duplicates, a RUNJOB after its JOBOBIT and a JOBOBIT for a job that
    never ran included in the idempotent form — then ``resync_jobs``
    and ``resync_free_nodes``: mirrors bitwise equal (tolerance: none;
    the updates are f32 adds and integer counts)."""
    stream = [(0, 1.5, 0, {"nodes": 4.0, "est_runtime": 100.3}),
              (0, 2.25, 1, {"nodes": 2.0, "est_runtime": 40.0}),
              (0, 3.0, 2, {"nodes": 8.0, "est_runtime": 900.7}),
              (1, 3.5, 0, {}), (1, 4.0, 1, {}),
              (3, 10.0, -1, {"nodes": 2.0, "victim_job": 1.0}),
              (2, 50.125, 0, {}), (4, 60.0, -1, {"nodes": 2.0}),
              (1, 61.0, 2, {})]
    if idempotent:
        stream += [(0, 62.0, 0, {"nodes": 4.0, "est_runtime": 1.0}),
                   (2, 63.0, 1, {}), (1, 64.0, 1, {}), (2, 70.0, 2, {}),
                   (2, 71.0, 2, {})]
    js = jstate.empty_state(8, 16)
    ts = tstate.empty_state(8, 16, device="cpu")
    for i, (kind, t, job, payload) in enumerate(stream):
        js, jc = jsync.apply_event(js, JEvent(JKind(kind), t, job, payload),
                                   idempotent=idempotent)
        ts, tc = tsync.apply_event(ts, TEvent(TKind(kind), t, job, payload),
                                   idempotent=idempotent)
        assert tc == jc, f"event {i}"
        _mirror_equal(ts, js, f"event {i}")
    assert tstate.validate_invariants(ts) == jstate.validate_invariants(js)
    view = {"submit_t": np.array([1.5, 2.25, 3.0, -1, -1, -1, -1, -1]),
            "nodes": np.array([4, 2, 8, 0, 0, 0, 0, 0]),
            "est_runtime": np.array([100.3, 40.0, 900.7, 0, 0, 0, 0, 0]),
            "start_t": np.array([3.5, 64.0, 61.0, -1, -1, -1, -1, -1]),
            "end_t": np.array([50.125, -1, -1, -1, -1, -1, -1, -1]),
            "state": np.array([3, 2, 2, 0, 0, 0, 0, 0]),
            "free_nodes": 6, "total_nodes": 16}
    _mirror_equal(tsync.resync_jobs(ts, view), jsync.resync_jobs(js, view),
                  "resync_jobs")
    _mirror_equal(tsync.resync_free_nodes(ts, 5),
                  jsync.resync_free_nodes(js, 5), "resync_free_nodes")


@pytest.mark.parametrize("policy", ["wfp", "fcfs", "sjf"])
def test_emulator_static_mode_matches(policy):
    """Static mode: the emulator schedules itself with one policy through
    the engine's k=1 pass at every event.  Same report (rtol 1e-6, host
    f64 over identical schedules) and identical start times."""
    trace = twl.poisson_trace(24, 16, 8.0, (1, 16), (30.0, 900.0), seed=5)
    jtrace = [jwl.JobSpec(**dataclasses.asdict(j)) for j in trace]
    jrep = ClusterEmulator(jtrace, 16, engine=DrainEngine("reference")).run(
        jparse(policy).fork(0))
    trep = TEmulator(trace, 16, engine=TEngine(device="cpu")).run(
        tparse(policy).fork(0))
    np.testing.assert_array_equal(trep.start_t, jrep.start_t)
    np.testing.assert_allclose(list(trep.metric_dict().values()),
                               list(jrep.metric_dict().values()), rtol=1e-6)
