"""Chaos, crash-safe snapshots and the resilience CLI modes of the port
(``repro_torch.cluster.chaos``, ``SchedTwin.snapshot``/``restore``, the
emulator's ``snapshot_state``/``restore_state``, ``twin_loop --chaos``,
``--snapshot-dir``/``--kill-after-cycle``/``--resume``, ``--train`` and
``--pool trained:``) against the JAX package, on the CPU.

* ``ChaosBus``: the delivered stream (seq, kind, time, job id, payload)
  and the injection counts equal the reference's over the same bus, for
  seeded and hypothesis-drawn specs; ``failure_storm`` and ``ChaosSpec``
  validation equal.
* Snapshots: a twin restored mid-run into a fresh twin makes the
  uninterrupted run's remaining decisions, bitwise (cycle time, winner,
  started jobs), for plain, ensemble (the key chain rides the snapshot)
  and fan twins; ``app_extra`` round-trips.  A JAX twin's snapshot
  restored in the port makes the JAX twin's remaining decisions, and the
  other way round.
* The CLI modes print the JAX CLI's report (``--backend reference``)
  line for line, its first line (the port's names the device), wall
  times and checkpoint paths aside.
"""
import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JManager
from repro.cluster import chaos as jchaos
from repro.cluster.emulator import ClusterEmulator as JEmulator
from repro.cluster.workload import JobSpec as JJob
from repro.core.engine import DrainEngine as JEngine
from repro.core.events import BusReadError as JReadError
from repro.core.events import Event as JEvent
from repro.core.events import EventBus as JBus
from repro.core.twin import SchedTwin as JTwin
from repro.launch import twin_loop as jloop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.cluster import chaos
from repro_torch.cluster.emulator import ClusterEmulator
from repro_torch.cluster.workload import JobSpec
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import BusReadError, Event, EventBus
from repro_torch.core.fan import FanSpec
from repro_torch.core.twin import SchedTwin
from repro_torch.launch import twin_loop as tloop

ENG = DrainEngine("reference", device="cpu")
JENG = JEngine("reference")


def tiny_trace(n=12, seed=0, cls=JobSpec):
    rng = np.random.default_rng(seed)
    jobs, t = [], 0.0
    for j in range(n):
        jobs.append(cls(job_id=j, submit_t=t,
                        nodes=int(rng.integers(1, 6)),
                        est_runtime=float(rng.uniform(20, 80)),
                        true_runtime=float(rng.uniform(10, 80))))
        t += 4.0
    return jobs


# ----------------------------------------------------------------------
# ChaosBus: the same delivered stream as the reference's
# ----------------------------------------------------------------------

def _events(cls, n=64):
    return [cls(kind=(j % 5), time=float(j), job_id=j % 8,
                payload={"nodes": 1.0, "est_runtime": 5.0})
            for j in range(n)]


def _delivery(bus_cls, chaos_mod, err, event_cls, spec_kw, n=64, reads=8):
    bus = bus_cls()
    view = chaos_mod.ChaosBus(bus, chaos_mod.ChaosSpec(**spec_kw))
    for ev in _events(event_cls, n):
        bus.publish(ev)
    out, per_read, consumed = [], max(1, n // reads), 0
    while consumed < n:
        try:
            got = view.read("c", per_read)
        except err:
            out.append("read failure")
            continue
        consumed += per_read
        out.extend((e.seq, int(e.kind), repr(e.time), e.job_id,
                    sorted((k, repr(v)) for k, v in e.payload.items()))
                   for e in got)
    return out, dict(view.stats)


def _both(spec_kw, **kw):
    a = _delivery(EventBus, chaos, BusReadError, Event, spec_kw, **kw)
    b = _delivery(JBus, jchaos, JReadError, JEvent, spec_kw, **kw)
    return a, b


@pytest.mark.parametrize("seed", [0, 3, 13, 2**40 + 1])
def test_default_profile_stream_matches_reference(seed):
    spec_kw = dataclasses.asdict(dataclasses.replace(
        chaos.DEFAULT_PROFILE, seed=seed))
    (a, sa), (b, sb) = _both(spec_kw, n=96)
    assert a == b and sa == sb
    assert sum(sa.values()) > 0


def test_hypothesis_chaos_streams_match_reference():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    prob = st.floats(0.0, 0.6)

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2**32), drop=prob, dup=prob, reorder=prob,
           delay=st.integers(1, 6), corrupt=prob, fail=st.floats(0, 0.5),
           n=st.integers(1, 80), reads=st.integers(1, 12))
    def run(seed, drop, dup, reorder, delay, corrupt, fail, n, reads):
        spec_kw = dict(drop_prob=drop, duplicate_prob=dup,
                       reorder_prob=reorder, reorder_delay=delay,
                       corrupt_prob=corrupt, read_failure_prob=fail,
                       seed=seed)
        a, b = _both(spec_kw, n=n, reads=reads)
        assert a == b

    run()


def test_unit_hash_and_failure_storm_match_reference():
    for keys in [(0,), (1, 2), (0xD209, 77), (2**63, 5, 9)]:
        for seed in (0, 1, 2**40):
            assert chaos._unit(seed, *keys) == jchaos._unit(seed, *keys)
    for kw in [dict(start=100.0), dict(start=0.0, waves=5, nodes=2,
                                       spacing_s=50.0, duration_s=0.0)]:
        assert [dataclasses.astuple(f) for f in chaos.failure_storm(**kw)] \
            == [dataclasses.astuple(f) for f in jchaos.failure_storm(**kw)]
    assert chaos.DEFAULT_PROFILE == chaos.ChaosSpec(
        **dataclasses.asdict(jchaos.DEFAULT_PROFILE))


@pytest.mark.parametrize("kw,match", [(dict(drop_prob=1.5), "drop_prob"),
                                      (dict(corrupt_prob=-0.1),
                                       "corrupt_prob"),
                                      (dict(reorder_delay=0),
                                       "reorder_delay")])
def test_chaos_spec_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        chaos.ChaosSpec(**kw)
    with pytest.raises(ValueError) as ref:
        jchaos.ChaosSpec(**kw)
    assert str(port.value) == str(ref.value)


def test_chaos_bus_delegates_to_the_real_bus():
    bus = EventBus()
    view = chaos.ChaosBus(bus, chaos.ChaosSpec())
    view.publish(_events(Event, 1)[0])
    assert len(view) == len(bus) == 1
    assert view.health() == bus.health()


# ----------------------------------------------------------------------
# snapshots: bitwise decision parity
# ----------------------------------------------------------------------

def decisions(twin):
    return [(float(c.time), c.policy,
             tuple(int(j) for j in c.started_jobs))
            for c in twin.telemetry.cycles]


def _build(pkg, trace, bus=None, **twin_kw):
    port = pkg == "port"
    bus = bus if bus is not None else (EventBus() if port else JBus())
    em = (ClusterEmulator if port else JEmulator)(
        trace, 16, bus=bus, **({"engine": ENG} if port else {}))
    twin = (SchedTwin if port else JTwin)(
        bus=bus, qrun=em.qrun, total_nodes=16, max_jobs=em.max_jobs,
        free_nodes_probe=lambda: em.free_nodes, jobs_probe=em.jobs_view,
        engine=ENG if port else JENG, sleep=lambda s: None, **twin_kw)
    return bus, em, twin


class _Killed(Exception):
    pass


def _run_and_kill(pkg, trace, root, kill_at, **twin_kw):
    """Run until ``kill_at`` cycles, snapshot (with the emulator and the
    bus as ``twin_loop`` stores them) and stop, as a crash would."""
    bus, em, twin = _build(pkg, trace, **twin_kw)
    mgr = (CheckpointManager if pkg == "port" else JManager)(root)

    def pump():
        twin.pump()
        if len(twin.telemetry.cycles) >= kill_at:
            twin.snapshot(mgr, app_extra={"emulator": em.snapshot_state(),
                                          "bus": bus.dump()})
            raise _Killed
    with pytest.raises(_Killed):
        em.run(on_event=pump, on_quiesce=twin.flush)


def _resume(pkg, trace, root, **twin_kw):
    """Rebuild the bus from the snapshot's log, restore the emulator and
    a fresh twin, and run to the end."""
    port = pkg == "port"
    mgr = (CheckpointManager if port else JManager)(root)
    app = mgr.restore(mgr.latest_step(), {}, **(
        {"device": "cpu"} if port else {}))[1]["app"]
    bus = (EventBus if port else JBus).from_dump(app["bus"])
    _, em, twin = _build(pkg, trace, bus=bus, **twin_kw)
    step, app2 = twin.restore(mgr)
    assert app2 == app and step == len(twin.telemetry.cycles)
    em.restore_state(app["emulator"])
    report = em.run(on_event=twin.pump, on_quiesce=twin.flush)
    assert report.n_jobs == len(trace)
    return twin


TWINS = {"plain": {}, "ensemble": dict(ensemble=4, seed=3),
         "fan": dict(fan=FanSpec(n=4, runtime_noise=0.3, seed=1))}


@pytest.mark.parametrize("mode", sorted(TWINS))
def test_snapshot_restore_bitwise_decision_parity(tmp_path, mode):
    trace = tiny_trace(10, seed=5)
    kw = TWINS[mode]
    bus, em, twin = _build("port", trace, **kw)
    em.run(on_event=twin.pump, on_quiesce=twin.flush)
    ref = decisions(twin)

    bus, em, twin = _build("port", trace, **kw)
    mgr = CheckpointManager(str(tmp_path / mode))
    holder = {"twin": twin, "killed": False}

    def pump():
        t = holder["twin"]
        t.pump()
        if not holder["killed"] and len(t.telemetry.cycles) >= 4:
            t.snapshot(mgr)
            fresh = SchedTwin(bus=bus, qrun=em.qrun, total_nodes=16,
                              max_jobs=em.max_jobs,
                              free_nodes_probe=lambda: em.free_nodes,
                              jobs_probe=em.jobs_view, engine=ENG,
                              sleep=lambda s: None, **kw)
            step, app = fresh.restore(mgr)
            assert step == len(t.telemetry.cycles) and app is None
            assert len(fresh.telemetry.cycles) == step
            assert fresh._key.tolist() == t._key.tolist()
            holder["twin"] = fresh
            holder["killed"] = True

    report = em.run(on_event=pump,
                    on_quiesce=lambda: holder["twin"].flush())
    assert holder["killed"]
    assert report.n_jobs == len(trace)
    assert decisions(holder["twin"]) == ref


def test_snapshot_carries_app_extra(tmp_path):
    trace = tiny_trace(6, seed=6)
    bus, em, twin = _build("port", trace)
    em.run(on_event=twin.pump, on_quiesce=twin.flush)
    mgr = CheckpointManager(str(tmp_path))
    twin.snapshot(mgr, app_extra={"emulator": em.snapshot_state(),
                                  "bus": bus.dump()})
    bus2 = EventBus()
    em2 = ClusterEmulator(trace, 16, bus=bus2, engine=ENG)
    twin2 = SchedTwin(bus=bus2, qrun=em2.qrun, total_nodes=16,
                      max_jobs=em2.max_jobs, sleep=lambda s: None,
                      engine=ENG)
    step, app = twin2.restore(mgr)
    em2.restore_state(app["emulator"])
    assert em2.now == em.now and em2.free_nodes == em.free_nodes
    assert em2.snapshot_state() == em.snapshot_state()
    assert app["bus"] == bus.dump()
    assert decisions(twin2) == decisions(twin)
    assert twin2.telemetry.ingest.as_dict() == \
        twin.telemetry.ingest.as_dict()
    with pytest.raises(FileNotFoundError):
        twin2.restore(CheckpointManager(str(tmp_path / "none")))


def test_emulator_resumes_where_its_snapshot_cut(tmp_path):
    """A static run stopped mid-trace, its emulator snapshot restored
    into a fresh emulator, ends as the uninterrupted run (the restored
    heap is the one ``run`` continues from)."""
    trace = tiny_trace(12, seed=2)
    full = ClusterEmulator(trace, 16, engine=ENG).run(policy_id=1)
    em = ClusterEmulator(trace, 16, engine=ENG)
    state = {}
    orig = em._static_schedule

    def sched(policy):
        orig(policy)
        if em.n_events == 9 and not state:
            state.update(em.snapshot_state())
            raise _Killed
    em._static_schedule = sched
    with pytest.raises(_Killed):
        em.run(policy_id=1)
    fresh = ClusterEmulator(trace, 16, engine=ENG)
    fresh.restore_state(state)
    rep = fresh.run(policy_id=1)
    np.testing.assert_array_equal(rep.start_t, full.start_t)
    np.testing.assert_array_equal(rep.end_t, full.end_t)
    assert rep.metric_dict() == full.metric_dict()
    assert rep.n_events == full.n_events


@pytest.mark.parametrize("mode", ["plain", "ensemble"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_snapshots_cross_packages(tmp_path, writer, reader, mode):
    """A twin killed mid-run in one package resumes in the other and
    makes the writer's uninterrupted run's remaining decisions."""
    kw = TWINS[mode]
    trace_w = tiny_trace(10, seed=5, cls=JobSpec if writer == "port"
                         else JJob)
    trace_r = tiny_trace(10, seed=5, cls=JobSpec if reader == "port"
                         else JJob)
    bus, em, twin = _build(writer, trace_w, **kw)
    em.run(on_event=twin.pump, on_quiesce=twin.flush)
    ref = decisions(twin)
    root = str(tmp_path / "snap")
    _run_and_kill(writer, trace_w, root, 4, **kw)
    resumed = _resume(reader, trace_r, root, **kw)
    assert decisions(resumed) == ref


# ----------------------------------------------------------------------
# the CLI modes print the reference CLI's reports
# ----------------------------------------------------------------------

ARGS = ["--trace", "poisson", "--jobs", "30", "--nodes", "16", "--seed", "3"]
TRAIN = ["--train", "2", "--train-pop", "4", "--train-scenarios", "2",
         "--train-heldout", "1", "--trace", "poisson", "--jobs", "24",
         "--nodes", "16"]


def _port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            tloop.main(argv + ["--device", "cpu"])
        except SystemExit as e:
            print(f"exit: {e}")
    return buf.getvalue()


def _ref(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["twin_loop", "--no-compile-cache",
                                      "--backend", "reference"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            jloop.main()
        except SystemExit as e:
            print(f"exit: {e}")
    return buf.getvalue()


def _report(text, *dirs):
    """The report without its first line (the port's names the device),
    its wall-time lines and the checkpoint directories' names."""
    lines = [ln for ln in text.splitlines()[1:]
             if not ln.startswith(("cycle latency:", "trained "))]
    for d in dirs:
        lines = [ln.replace(d, "<dir>") for ln in lines]
    return lines


def test_twin_loop_chaos_matches_reference(monkeypatch):
    port = _port(ARGS + ["--chaos"])
    ref = _ref(ARGS + ["--chaos"], monkeypatch)
    assert _report(port) == _report(ref)
    assert "chaos injected:" in port and "dead letters:" in port


def test_twin_loop_kill_and_resume_match_reference(tmp_path, monkeypatch):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    kill = ["--chaos", "--kill-after-cycle", "12", "--snapshot-every", "5"]
    port = _port(ARGS + kill + ["--snapshot-dir", tdir])
    ref = _ref(ARGS + kill + ["--snapshot-dir", jdir], monkeypatch)
    assert _report(port, tdir) == _report(ref, jdir)
    assert "exit: killed after cycle 12" in port
    port = _port(ARGS + ["--chaos", "--resume", "--snapshot-dir", tdir])
    ref = _ref(ARGS + ["--chaos", "--resume", "--snapshot-dir", jdir],
               monkeypatch)
    assert _report(port, tdir) == _report(ref, jdir)
    assert "resumed from snapshot step 12" in port
    # the resumed run's metric table, what-if breakdown and policy mix
    # are the uninterrupted run's (the chaos bus keys read failures on
    # the process's read calls, which restart on resume, so its read
    # retries and injection counts may differ, as in the reference)
    full = _port(ARGS + ["--chaos"])
    keep = lambda t: [ln for ln in _report(t) if not ln.startswith(  # noqa
        ("resumed", "bus health", "resilience:"))]
    assert keep(port) == keep(full)


def test_twin_loop_train_and_trained_pool_match_reference(tmp_path,
                                                          monkeypatch):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    port = _port(TRAIN + ["--train-dir", tdir])
    ref = _ref(TRAIN + ["--train-dir", jdir], monkeypatch)
    assert _report(port, tdir) == _report(ref, jdir)
    assert "<- trained" in port and f"deploy: --pool trained:{tdir}" in port
    more = ["--train", "3", "--resume"]
    port = _port(TRAIN + ["--train-dir", tdir] + more)
    ref = _ref(TRAIN + ["--train-dir", jdir] + more, monkeypatch)
    assert _report(port, tdir) == _report(ref, jdir)
    assert "resumed gen 2" in port
    port = _port(ARGS + ["--pool", f"trained:{tdir},paper"])
    ref = _ref(ARGS + ["--pool", f"trained:{jdir},paper"], monkeypatch)
    assert _report(port) == _report(ref)
    assert "trained[lin]" in port


@pytest.mark.parametrize("flag", [
    ["--train", "2", "--replay-grid", "2"], ["--train", "2", "--chaos"],
    ["--train", "2", "--resume"], ["--train-pop", "4"],
    ["--kill-after-cycle", "3"], ["--resume"],
    ["--replay-grid", "2", "--chaos"],
    ["--replay-grid", "2", "--snapshot-dir", "d"]])
def test_twin_loop_refuses_what_the_reference_refuses(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tloop.main(ARGS + ["--device", "cpu"] + flag)
    assert exc.value.code == 2
    assert "not yet ported" not in capsys.readouterr().err
