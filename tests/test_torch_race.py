"""The port's fan racing (``repro_torch.core.race``), its ensemble
decisions and the twin's Monte-Carlo modes on the CPU, against their own
invariants and the JAX package.

Corpus: ``tests/test_race.py``'s three poisson traces (12 jobs, 16 nodes),
pool ``fcfs,sjf,saf``, ``NOISY`` fan raced from F₀ = 2; ``tests/
test_fan.py``-style cluster snapshots (J=48) for the drain surfaces.

The port's own invariants (counterparts of ``tests/test_race.py``): the
rung schedule and validation; a fan window is bitwise the same slice of
the full fan; an unbudgeted race selects the full fan's winner (also
fuzzed over synthetic member tensors, with ties and +inf); F₀ = F_max is
bitwise ``fan_grid``; ties and +inf never eliminate; ``max_members`` and
``budget_ms`` (an injected clock) stop mid-race with a consistent
rectangle; no member is replayed twice; ``decide_race`` at F₀ = F_max is
bitwise ``decide_fan``; the twin's race stamps; ``fit_runtime_sigma``
and ``FanSpec.from_history``.

Against the reference: ``race_grid`` and ``decide_race`` (rungs,
eliminations, members, winners identical; costs rtol 1e-5, ROADMAP C4);
``decide_ensemble`` with the same threefry key (winner, qrun set and
deadlocks identical, costs rtol 1e-5).  The twin's co-simulations in
these modes against the reference's are in
``tests/test_torch_twin_modes.py``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cluster_state
from repro.cluster import workload as jwl
from repro.core import fan as jfan
from repro.core import race as jrace
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import parse_pool as jparse
from repro_torch.cluster import workload as twl
from repro_torch.cluster.emulator import ClusterEmulator as TEmulator
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import prng
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.events import EventBus as TBus
from repro_torch.core.fan import FanSpec, fit_runtime_sigma, pruned_fan_grid
from repro_torch.core.objective import parse_objective
from repro_torch.core.policies import parse_pool as tparse
from repro_torch.core.race import (RaceSpec, decide_race, normalize_race,
                                   race_grid, run_race)
from repro_torch.core.twin import SchedTwin as TTwin
from repro_torch.core.whatif import decide_ensemble
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
TREF = TEngine("reference", device="cpu")
JREF = JEngine("reference")
POOL = tparse("fcfs,sjf,saf")
JPOOL = jparse("fcfs,sjf,saf")
NOISY_KW = dict(n=8, runtime_noise=0.3, burst_amplitude=0.5,
                burst_period=600.0, failure_prob=0.3, seed=7)
NOISY = FanSpec(**NOISY_KW)
RACE = RaceSpec(fan=NOISY, f0=2)
IDS = torch.tensor([0, 1, 2], dtype=torch.int32)
JIDS = jnp.asarray([0, 1, 2], jnp.int32)


def _traces(wl):
    return [wl.poisson_trace(12, 16, 30.0, (1, 4), (60.0, 600.0), seed=s)
            for s in range(3)]


@pytest.fixture(scope="module")
def scen():
    return twl.stack_scenarios(_traces(twl), total_nodes=16)


@pytest.fixture(scope="module")
def jscen():
    return jwl.stack_scenarios(_traces(jwl), total_nodes=16)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _serve(member):
    return lambda act, lo, hi: member[:, lo:hi, :][:, :, act]


# ----------------------------------------------------------------------
# schedule and validation
# ----------------------------------------------------------------------

def test_rung_schedule():
    assert RaceSpec(fan=FanSpec(n=64), f0=8).rungs() == (
        (0, 8), (8, 16), (16, 32), (32, 64))
    assert RaceSpec(fan=FanSpec(n=24), f0=8).rungs() == (
        (0, 8), (8, 16), (16, 24))
    assert RaceSpec(fan=FanSpec(n=8), f0=8).rungs() == ((0, 8),)
    assert RaceSpec(fan=FanSpec(n=8), f0=64).rungs() == ((0, 8),)
    assert RaceSpec(fan=FanSpec(n=100), f0=3, growth=3).rungs() == \
        jrace.RaceSpec(fan=jfan.FanSpec(n=100), f0=3, growth=3).rungs()


def test_spec_validation():
    for bad in (dict(f0=0), dict(growth=1), dict(z=0.0),
                dict(budget_ms=-1.0), dict(max_members=0)):
        with pytest.raises(ValueError):
            RaceSpec(**bad)
    assert normalize_race(NOISY).fan is NOISY
    assert normalize_race(16).f_max == 16
    assert normalize_race(RACE) is RACE


# ----------------------------------------------------------------------
# the grid surface
# ----------------------------------------------------------------------

def test_fan_window_is_bitwise_fan_slice(scen):
    full = TREF.fan_grid(scen, POOL.spec, NOISY, "avg_wait")
    for lo, hi in ((0, 2), (2, 4), (4, 8), (3, 4)):
        win = TREF.fan_window_grid(scen, POOL.spec, NOISY, "avg_wait",
                                   lo=lo, width=hi - lo)
        _eq(win.member_costs, full.member_costs[:, lo:hi], f"[{lo},{hi})")
        _eq(win.start_t, full.start_t[:, lo:hi])


def test_fan_window_validates():
    for lo, width in ((-1, 2), (4, 8), (0, 0)):
        with pytest.raises(ValueError):
            TREF.fan_window_grid(None, POOL.spec, NOISY, lo=lo, width=width)


@pytest.mark.parametrize("goal", ["score", "p95:avg_wait"])
def test_race_winner_matches_fan_grid(scen, goal):
    full = TREF.fan_grid(scen, POOL.spec, NOISY, goal)
    out = race_grid(scen, POOL.spec, RACE, goal, engine=TREF)
    _eq(out.best, full.best)
    _eq(out.member_costs,
        _np(full.member_costs)[:, :out.fan_size, :][:, :, out.keep])


def test_race_duplicated_pool_real_ties(scen):
    dup = tparse("fcfs,sjf,fcfs")
    full = TREF.fan_grid(scen, dup.spec, NOISY, "score")
    out = race_grid(scen, dup.spec, RACE, "score", engine=TREF)
    _eq(out.best, full.best)
    assert all(int(b) in set(int(i) for i in out.keep)
               for b in _np(full.best))


def test_race_f0_equals_fmax_is_bitwise_fan_grid(scen):
    full = TREF.fan_grid(scen, POOL.spec, NOISY, "score")
    out = race_grid(scen, POOL.spec, RaceSpec(fan=NOISY, f0=NOISY.n),
                    "score", engine=TREF)
    assert len(out.rungs) == 1 and out.fan_size == NOISY.n
    assert out.members == out.members_full
    _eq(out.member_costs, full.member_costs)
    _eq(out.costs, full.costs)
    _eq(out.best, full.best)


def test_race_winner_invariance_synthetic_fuzz():
    goal = parse_objective("mean:avg_wait")
    rng = np.random.default_rng(11)
    for trial in range(60):
        S, P = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        member = np.tile(
            rng.integers(-5, 6, size=(S, 1, P)).astype(np.float32),
            (1, 8, 1))
        if trial % 3 == 0:
            member[rng.random(size=(S, 1, P)).repeat(8, 1) < 0.2] = np.inf
        out = run_race(RaceSpec(fan=FanSpec(n=8), f0=2), S, P, goal,
                       _serve(member))
        _eq(out.best, np.argmin(member.mean(axis=1), axis=1),
            f"trial {trial}")


def test_single_policy_separates_immediately(scen):
    member = np.abs(np.random.default_rng(0).normal(
        size=(2, 8, 1))).astype(np.float32)
    out = run_race(RaceSpec(fan=FanSpec(n=8), f0=2), 2, 1,
                   parse_objective("mean:avg_wait"), _serve(member))
    assert out.stopped == "separated" and out.separated
    assert out.fan_size == 2 and (out.separation == np.inf).all()
    solo = race_grid(scen, tparse("fcfs").spec, RACE, "score", engine=TREF)
    assert solo.stopped == "separated" and solo.fan_size == RACE.f0
    _eq(solo.best, [0, 0, 0])


def test_all_tied_costs_never_eliminate():
    member = np.tile(np.random.default_rng(1).normal(
        size=(2, 8, 1)).astype(np.float32), (1, 1, 4))
    out = run_race(RaceSpec(fan=FanSpec(n=8), f0=2), 2, 4,
                   parse_objective("mean:avg_wait"), _serve(member))
    assert out.stopped == "exhausted" and not out.separated
    assert list(out.keep) == [0, 1, 2, 3]
    assert all(r.eliminated == () for r in out.rungs)
    _eq(out.best, [0, 0])


def test_inf_at_rung0_never_eliminated():
    member = np.zeros((1, 8, 3), np.float32)
    member[0, :, 0] = 1.0
    member[0, :, 1] = 100.0
    member[0, 0, 1] = np.inf
    member[0, :, 2] = 50.0
    out = run_race(RaceSpec(fan=FanSpec(n=8), f0=2), 1, 3,
                   parse_objective("mean:avg_wait"), _serve(member))
    assert 1 in out.keep and 2 not in out.keep
    _eq(out.best, [0])


def test_max_members_stops_mid_race():
    member = np.random.default_rng(2).normal(
        size=(2, 16, 3)).astype(np.float32)
    member[:, :2, :] = member[:, :2, :1]
    spec = RaceSpec(fan=FanSpec(n=16), f0=2, max_members=12)
    out = run_race(spec, 2, 3, parse_objective("mean:avg_wait"),
                   _serve(member))
    assert out.stopped == "max_members"
    assert out.members == 12 and out.fan_size == 2
    assert out.costs.shape == (2, len(out.keep)) == out.cost_ci.shape


def test_budget_ms_stops_mid_race_with_injected_clock(scen):
    """``budget_ms`` reads the injected clock; rung 0 always runs.  The
    grid and drain surfaces take the clock too."""
    def ticking():
        t = [0.0]

        def clock():
            t[0] += 1.0
            return t[0]
        return clock

    member = np.random.default_rng(3).normal(
        size=(1, 16, 3)).astype(np.float32)
    member[:, :2, :] = member[:, :2, :1]
    spec = RaceSpec(fan=FanSpec(n=16), f0=2, budget_ms=1.0)
    out = run_race(spec, 1, 3, parse_objective("mean:avg_wait"),
                   _serve(member), clock=ticking())
    assert out.stopped == "budget_ms"
    assert out.fan_size == 2 and len(out.rungs) == 1
    tight = RaceSpec(fan=dataclasses.replace(NOISY, n=16), f0=2,
                     budget_ms=1.0)
    g = race_grid(scen, POOL.spec, tight, "score", engine=TREF,
                  clock=ticking())
    assert len(g.rungs) == 1 and g.fan_size == 2
    assert g.stopped in ("budget_ms", "separated")
    _, state = _states(1)[0]
    _, d = decide_race(state, IDS, tight, "score", engine=TREF,
                       clock=ticking())
    assert len(d.rungs) == 1 and d.fan_size == 2


def test_overlapping_window_raises():
    member = np.zeros((1, 8, 2), np.float32)

    class Cheat(RaceSpec):
        def rungs(self):
            return ((0, 2), (0, 2))

    with pytest.raises(RuntimeError, match="replay"):
        run_race(Cheat(fan=FanSpec(n=8), f0=2), 1, 2,
                 parse_objective("mean:avg_wait"),
                 lambda act, lo, hi: member[:, 0:hi - lo, :][:, :, act])


def test_no_member_replayed_twice_accounting(scen):
    triples, seen = set(), []

    def eval_window(active, lo, hi):
        for key in itertools.product(range(3), range(lo, hi),
                                     (int(p) for p in active)):
            assert key not in triples, f"replayed {key}"
            triples.add(key)
        seen.append((lo, hi))
        out = TREF.fan_window_grid(scen, POOL.spec, RACE.fan, "score",
                                   lo=lo, width=hi - lo)
        return _np(out.member_costs)[:, :, active]

    out = run_race(RACE, 3, 3, parse_objective("score"), eval_window)
    assert out.members == len(triples) == sum(r.members for r in out.rungs)
    assert all(a[1] == b[0] for a, b in zip(seen, seen[1:]))


def test_race_grid_spends_fewer_members_when_separable():
    traces = [twl.poisson_trace(24, 8, 5.0, (1, 6), (300.0, 3000.0), seed=s)
              for s in range(3)]
    hard = twl.stack_scenarios(traces, total_nodes=8)
    easy = FanSpec(n=32, runtime_noise=0.02, seed=3)
    out = race_grid(hard, POOL.spec, RaceSpec(fan=easy, f0=2), "avg_wait",
                    engine=TREF)
    full = TREF.fan_grid(hard, POOL.spec, easy, "avg_wait")
    _eq(out.best, full.best)
    assert out.members * 3 <= out.members_full
    assert out.stopped == "separated"
    assert 0 < out.passes <= int(full.result.pass_invocations)


@pytest.mark.parametrize("goal", ["score", "cvar:0.9:score"])
@pytest.mark.parametrize("kw", [NOISY_KW,
                                dict(n=16, runtime_noise=0.2,
                                     failure_prob=0.3, failure_domains=2,
                                     seed=4)], ids=["noisy", "domains"])
def test_race_grid_matches_reference(scen, jscen, goal, kw):
    """Rung for rung: the same windows, survivors, eliminations and
    members; winners identical; stats to C4's rtol."""
    spec = RaceSpec(fan=FanSpec(**kw), f0=2)
    jspec = jrace.RaceSpec(fan=jfan.FanSpec(**kw), f0=2)
    t = race_grid(scen, POOL.spec, spec, goal, engine=TREF)
    j = jrace.race_grid(jscen, JPOOL.spec, jspec, goal, engine=JREF)
    assert [(r.lo, r.hi, r.active, r.members, r.eliminated)
            for r in t.rungs] == [(r.lo, r.hi, r.active, r.members,
                                   r.eliminated) for r in j.rungs]
    assert (t.members, t.members_full, t.fan_size, t.stopped,
            t.separated) == (j.members, j.members_full, j.fan_size,
                             j.stopped, j.separated)
    _eq(t.best, j.best)
    _eq(t.keep, j.keep)
    np.testing.assert_allclose(t.member_costs, j.member_costs, rtol=RTOL)
    np.testing.assert_allclose(t.costs, j.costs, rtol=RTOL)
    assert t.passes == j.passes


# ----------------------------------------------------------------------
# pruning's donation accounting
# ----------------------------------------------------------------------

def test_pruned_fan_grid_donation_accounting(scen):
    easy = FanSpec(n=16, runtime_noise=0.02, seed=3)
    full = TREF.fan_grid(scen, POOL.spec, easy, "avg_wait")
    out, info = pruned_fan_grid(scen, POOL.spec, easy, "avg_wait",
                                engine=TREF, pre_n=2)
    _eq(info.best, full.best)
    _eq(out.member_costs, full.member_costs[:, :, info.keep])
    Pk = len(info.keep)
    assert info.members_full == 3 * 16 * 3
    assert info.members == 3 * (2 * 3 + 14 * Pk)


def test_pruned_fan_grid_matches_reference(scen, jscen):
    for kw, goal in ((dict(n=16, runtime_noise=0.02, seed=3), "avg_wait"),
                     (NOISY_KW, "p95:avg_wait")):
        t, ti = pruned_fan_grid(scen, POOL.spec, FanSpec(**kw), goal,
                                engine=TREF, pre_n=2)
        j, ji = jfan.pruned_fan_grid(jscen, JPOOL.spec, jfan.FanSpec(**kw),
                                     goal, engine=JREF, pre_n=2)
        _eq(ti.keep, ji.keep)
        _eq(ti.best, ji.best)
        assert (ti.rate, ti.members, ti.members_full) == (
            ji.rate, ji.members, ji.members_full)
        _eq(t.end_t, j.end_t)
        np.testing.assert_allclose(_np(t.costs), np.asarray(j.costs),
                                   rtol=RTOL)


# ----------------------------------------------------------------------
# the drain surfaces: decide_race and decide_ensemble
# ----------------------------------------------------------------------

def _states(n=3, n_queued=6):
    out = []
    for seed in range(n):
        js = make_cluster_state(max_jobs=48, total_nodes=32, seed=seed,
                                n_queued=n_queued + seed, n_running=2,
                                now=100.0 + 40.0 * seed)
        out.append((js, state_from_numpy(state_to_numpy(js), device="cpu")))
    return out


def test_decide_race_f0_fmax_is_bitwise_decide_fan():
    spec = FanSpec(n=8, runtime_noise=0.3, seed=5)
    for _, state in _states():
        df = TREF.decide_fan(state, IDS, spec, "p95:avg_wait")
        dr, out = TREF.decide_race(state, IDS, RaceSpec(fan=spec, f0=8),
                                   "p95:avg_wait")
        assert int(df.policy_index) == int(dr.policy_index)
        for f in ("costs", "cost_ci", "fan_width", "run_mask"):
            _eq(getattr(df, f), getattr(dr, f), f)
        assert dr.fan_size == spec.n == out.fan_size


def test_decide_race_winner_matches_decide_fan():
    spec = FanSpec(n=8, runtime_noise=0.3, seed=5)
    for _, state in _states(n_queued=8):
        df = TREF.decide_fan(state, IDS, spec, "score")
        dr, out = TREF.decide_race(state, IDS, RaceSpec(fan=spec, f0=2),
                                   "score")
        assert int(df.policy_index) == int(dr.policy_index)
        _eq(df.run_mask, dr.run_mask)
        assert out.fan_size == spec.n or out.stopped == "separated"


@pytest.mark.parametrize("goal", ["score", "p95:avg_wait"])
def test_decide_race_matches_reference(goal):
    kw = dict(n=16, runtime_noise=0.4, failure_prob=0.2, seed=5)
    for js, ts in _states(4, n_queued=8):
        td, tout = TREF.decide_race(ts, IDS, RaceSpec(
            fan=FanSpec(**kw), f0=2), goal)
        jd, jout = JREF.decide_race(js, JIDS, jrace.RaceSpec(
            fan=jfan.FanSpec(**kw), f0=2), goal)
        assert int(td.policy_index) == int(jd.policy_index)
        _eq(td.run_mask, jd.run_mask)
        _eq(td.deadlocked, jd.deadlocked)
        assert [(r.lo, r.hi, r.active, r.eliminated) for r in tout.rungs] \
            == [(r.lo, r.hi, r.active, r.eliminated) for r in jout.rungs]
        assert (td.fan_size, tout.stopped) == (jd.fan_size, jout.stopped)
        np.testing.assert_allclose(_np(td.costs), np.asarray(jd.costs),
                                   rtol=RTOL)
        assert list(td.cost_terms) == list(jd.cost_terms)


@pytest.mark.parametrize("n_ens,noise", [(2, 0.3), (4, 0.3), (8, 0.6)])
@pytest.mark.parametrize("goal", ["score", "avg_wait"])
def test_decide_ensemble_matches_reference(n_ens, noise, goal):
    """The same threefry key on both sides: the members' estimate
    factors are bitwise the reference's, so the winner, qrun set and
    deadlocks are identical; costs, CIs and spreads agree to C4's rtol."""
    for i, (js, ts) in enumerate(_states(3)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(3), i)
        tkey = prng.fold_in(prng.PRNGKey(3), i)
        jd = JREF.decide_ensemble(js, JIDS, jkey, n_ens=n_ens, noise=noise,
                                  objective=goal)
        td = decide_ensemble(ts, IDS, tkey, n_ens=n_ens, noise=noise,
                             objective=goal, engine=TREF)
        assert int(td.policy_index) == int(jd.policy_index)
        _eq(td.run_mask, jd.run_mask)
        _eq(td.deadlocked, jd.deadlocked)
        assert td.fan_size == jd.fan_size == n_ens
        np.testing.assert_allclose(_np(td.costs), np.asarray(jd.costs),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(td.cost_ci), np.asarray(jd.cost_ci),
                                   rtol=1e-4)
        np.testing.assert_allclose(_np(td.fan_width),
                                   np.asarray(jd.fan_width), rtol=1e-4)
        assert list(td.cost_terms) == list(jd.cost_terms)


def test_decide_ensemble_member_zero_keeps_the_reference_factor():
    """Member 0's normals are zeroed, so its estimates are scaled by
    ``exp(-noise²/2)``, as in the reference (ROADMAP C10): with one
    policy and n_ens = 1 the qrun set is that of the scaled snapshot."""
    _, state = _states(1)[0]
    d = TREF.decide_ensemble(state, IDS[:1], prng.PRNGKey(0), n_ens=1,
                             noise=0.3)
    scaled = state._replace(jobs=state.jobs._replace(
        est_runtime=state.jobs.est_runtime
        * prng.exp_f32(torch.tensor(-0.045, dtype=torch.float32))))
    _eq(d.run_mask, TREF.decide(scaled, IDS[:1]).run_mask)


# ----------------------------------------------------------------------
# the twin's race mode
# ----------------------------------------------------------------------

def test_twin_race_stamps_telemetry():
    trace = twl.poisson_trace(10, 16, 20.0, (1, 4), (30.0, 300.0), seed=1)
    bus = TBus()
    em = TEmulator(trace, 16, bus=bus, engine=TREF)
    twin = TTwin(bus=bus, qrun=em.qrun, total_nodes=16, engine=TREF,
                 max_jobs=em.max_jobs,
                 race=RaceSpec(fan=FanSpec(n=4, runtime_noise=0.3), f0=2),
                 objective="p95:avg_wait",
                 free_nodes_probe=lambda: em.free_nodes)
    em.run(on_event=twin.pump)
    recs = twin.telemetry.cycles
    assert recs and all(r.race_stopped and r.race_rungs >= 1 for r in recs)
    assert all(0 < r.race_members <= 4 * 3 for r in recs)
    assert all(1 <= r.fan_size <= 4 for r in recs)
    assert twin.telemetry.runtime_residuals
    for st in twin.telemetry.confidence_stats().values():
        assert st["min_fan"] <= st["max_fan"]


def test_twin_rejects_race_plus_fan_or_ensemble():
    for kw in (dict(race=RaceSpec(), fan=FanSpec(n=4)),
               dict(race=RaceSpec(), ensemble=4)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            TTwin(bus=TBus(), qrun=lambda j, t: None, total_nodes=8,
                  device="cpu", **kw)


# ----------------------------------------------------------------------
# fitting the noise to history
# ----------------------------------------------------------------------

def test_fit_runtime_sigma_recovers_lognormal():
    rng = np.random.default_rng(0)
    est = rng.uniform(60.0, 600.0, size=4000)
    actual = est * np.exp(rng.normal(0.0, 0.4, size=est.shape))
    got = fit_runtime_sigma(list(zip(est, actual)))
    assert got == pytest.approx(0.4, rel=0.1)
    assert got == jfan.fit_runtime_sigma(list(zip(est, actual)))


def test_fit_runtime_sigma_fallback_and_filtering():
    assert fit_runtime_sigma([]) == 0.3
    assert fit_runtime_sigma([(100.0, 110.0)], fallback=0.7) == 0.7
    pairs = ([(100.0, np.inf), (0.0, 50.0), (100.0, -5.0)]
             + [(100.0, 100.0 * np.exp(0.2 * (-1) ** i))
                for i in range(20)])
    got = fit_runtime_sigma(pairs)
    assert np.isfinite(got) and got > 0


def test_fanspec_from_history():
    from repro_torch.core.telemetry import Telemetry
    rng = np.random.default_rng(1)
    est = rng.uniform(60.0, 600.0, size=500)
    actual = est * np.exp(rng.normal(0.0, 0.25, size=est.shape))
    spec = FanSpec.from_history(list(zip(est, actual)), n=16,
                                failure_prob=0.1)
    assert spec.n == 16 and spec.failure_prob == 0.1
    assert spec.runtime_noise == pytest.approx(0.25, rel=0.2)
    tel = Telemetry()
    for e, a in zip(est, actual):
        tel.record_residual(e, a)
    assert FanSpec.from_history(tel, n=16, failure_prob=0.1) == spec
    assert FanSpec.from_history(Telemetry(), n=4).runtime_noise == 0.3
