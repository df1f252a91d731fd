"""The plain reference against the program, piece by piece and end to
end at CPU sizes: each entry's run agrees with it bit for bit."""
import numpy as np
import pytest
import torch

from twinbench.gen import scheduler, traces
from twinbench.reference import draws, mirror, sim
from twinbench.tests import tiny

POOLS = ("paper", "extended,wfp:a=1..5x5:tau=600..7200x5",
         "extended,wfp:a=1..2x2:tau=600..1200x2")


@pytest.mark.parametrize("spec", POOLS)
def test_pool_matches_program(spec):
    from repro_torch.core.policies import parse_pool
    prog, ref = parse_pool(spec), sim.pool(spec)
    assert ref.names == prog.names
    assert torch.equal(ref.family, prog.spec.family)
    assert torch.equal(ref.theta, prog.spec.theta)


def _pass_inputs(seed, k=8, J=96, collide=False):
    """Random pass inputs: queued-first orders, running jobs' ends, a
    600 s grid of ends and estimates when ``collide`` (many ties)."""
    rng = np.random.default_rng(seed)
    state = rng.choice([0, sim.QUEUED, sim.RUNNING, sim.DONE], size=(k, J),
                       p=[0.1, 0.55, 0.15, 0.2]).astype(np.int32)
    nodes = rng.integers(1, 12, size=(k, J)).astype(np.int32)
    nodes[rng.random((k, J)) < 0.05] = 60
    est = rng.uniform(300.0, 86400.0, size=(k, J)).astype(np.float32)
    now = rng.uniform(0.0, 5e4, size=k).astype(np.float32)
    end = (now[:, None] + rng.uniform(0.0, 4e4, size=(k, J))).astype(
        np.float32)
    if collide:
        end = (np.floor(end / 600.0) * 600.0).astype(np.float32)
        est = (np.ceil(est / 600.0) * 600.0).astype(np.float32)
    used = np.where(state == sim.RUNNING, nodes, 0).sum(1)
    free = np.maximum(80 - used, rng.integers(0, 30, size=k)).astype(np.int32)
    keys = np.where(state == sim.QUEUED, rng.random((k, J)), np.inf)
    order = np.argsort(keys, axis=1, kind="stable").astype(np.int32)
    t = torch.from_numpy
    return t(order), t(state), t(nodes), t(est), t(end), t(free), t(now)


@pytest.mark.parametrize("collide", (False, True))
@pytest.mark.parametrize("seed", range(4))
def test_easy_pass_matches_program(seed, collide):
    from repro_torch.core.backfill import schedule_pass_batched
    order, state, nodes, est, end, free, now = _pass_inputs(seed,
                                                           collide=collide)
    k, J = order.shape
    f = sim.Forks(torch.zeros(k, J), nodes, est, torch.zeros(k, J), end,
                  state, free, free, now)
    got = sim.easy_pass(f, order.long())
    want = schedule_pass_batched(order, state, nodes, est, end, free, now)[0]
    assert torch.equal(got, want)
    assert got.any()


@pytest.mark.parametrize("seed", (0, 12345, 2**31 + 5))
def test_member_draws_match_program(seed):
    from repro_torch.core import fan
    phi = torch.arange(6)
    s = torch.zeros_like(phi)
    z, u = draws.member_draws(seed, s, phi, 40)
    z_p, _, u_p = fan._member_draws(seed, s, phi, 40)
    assert torch.equal(z, z_p) and torch.equal(u, u_p)
    assert torch.equal(draws.lognormal_scale(z, 0.3),
                       fan.lognormal_scale(z_p, 0.3))
    spec = fan.FanSpec(n=6, failure_prob=0.5, seed=seed)
    total = torch.full((6,), 560, dtype=torch.int32)
    assert torch.equal(draws.failure_downs(0.5, 0.25, phi, u, total),
                       fan.failure_downs(spec, s, phi, u_p, total))


def test_mirror_matches_program_ingest():
    from repro_torch.core import sync
    from repro_torch.core.events import Event, EventKind
    from repro_torch.core.state import empty_state
    rng = np.random.default_rng(4)
    tr = traces.draw(dict(tiny.POISSON, scenarios=1, n_jobs=50,
                          mean_gap=4.0), rng, 16)
    sched = scheduler.StandIn({k: v[0] for k, v in tr.items()}, 16, 2)
    ref = mirror.Mirror(64, 16)
    st = empty_state(64, 16, device="cpu")
    for step in range(6):
        if step:
            queued = [j for j in range(50) if ref.state[j] == sim.QUEUED]
            sched.qrun(queued[:3], float(ref.now) + 1.0)
            sched.finish_due()
        for ev in sched.take():
            ref.apply(*ev)
            st, _ = sync.apply_event(st, Event(EventKind(ev[0]), *ev[1:]),
                                     idempotent=True)
        a = ref.arrays()
        j = st.jobs
        for name, t in (("submit", j.submit_t), ("nodes", j.nodes),
                        ("est", j.est_runtime), ("start", j.start_t),
                        ("end", j.end_t), ("state", j.state),
                        ("free", st.free_nodes), ("total", st.total_nodes),
                        ("now", st.now)):
            assert np.array_equal(np.asarray(a[name]), t.numpy()), name
    assert (ref.state == sim.DONE).any() and (ref.state == sim.RUNNING).any()


@pytest.mark.parametrize("kind", ("poisson", "paper"))
def test_rows_match_program_stacking(kind):
    from repro_torch.cluster.workload import JobSpec, stack_scenarios
    rng = np.random.default_rng(9)
    spec = (dict(tiny.POISSON, scenarios=3, n_jobs=20, mean_gap=30.0)
            if kind == "poisson" else tiny.paper_mix()["traces"])
    total = 32
    tr = traces.draw(spec, rng, total)
    S, n = tr["nodes"].shape
    jobs = [[JobSpec(j, float(tr["submit"][s, j]), int(tr["nodes"][s, j]),
                     float(tr["est"][s, j]), float(tr["true"][s, j]))
             for j in range(n)] for s in range(S)]
    scen = stack_scenarios(jobs, total)
    rows = traces.padded(tr, traces.table_width(n), total)
    for name, a in (("submit", scen.submit_t), ("nodes", scen.nodes),
                    ("est", scen.est_runtime), ("true", scen.true_runtime),
                    ("valid", scen.valid), ("total", scen.total_nodes)):
        assert a.dtype == rows[name].dtype and np.array_equal(a, rows[name])


@pytest.mark.parametrize("workload", sorted(tiny.WORKLOADS))
def test_entry_agrees_with_reference(tiny_root, workload):
    r = tiny.run(tiny_root, workload, seed=11)
    out = r.extra["out"]
    assert out["correct"], r.checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(c.value == 0 for c in r.checks), r.checks


def _cycle_run(tiny_root, units):
    """The tiny cycle cell set up and driven for ``units`` episodes of two
    cycles on the CPU, before its check."""
    import json

    from twinbench import harness
    bench = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, "tiny-16.cycle4", tiny_root)
    run = harness.Run(cell=cell, seed=2**31 + 5, seconds=0.0, trace=False,
                      device="cpu", root=tiny_root)
    st = cell.entry.setup(run)
    for _ in range(units):
        cell.entry.unit(st, harness.Recorder())
    run.attempted = 2 * units
    return cell, run, st


def test_cycle_episodes_agree_with_reference(tiny_root):
    cell, run, st = _cycle_run(tiny_root, 2)
    assert len(st.fans) == 3 and len(st.log) == 5
    assert [e for e, *_ in st.log] == [0, 1, 1, 2, 2]
    checks = cell.entry.check(st, run)
    assert all(c.value == 0 for c in checks) and run.failed == 0, checks


def test_cycle_check_holds_every_qrun(tiny_root):
    """A qrun set altered in a cycle the decisions' sample leaves out
    (the warm cycle) is found."""
    import dataclasses
    cell, run, st = _cycle_run(tiny_root, 1)
    e, evs, state, cyc = st.log[0]
    assert cyc.started_jobs
    st.log[0] = (e, evs, state, dataclasses.replace(
        cyc, started_jobs=list(cyc.started_jobs)[1:]))
    checks = cell.entry.check(st, run)
    assert run.extra["exact_parts"]["qrun"] == 1 and run.failed == 1
    assert not all(c.ok for c in checks)
