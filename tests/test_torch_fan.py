"""The port's Monte-Carlo fans (``repro_torch.core.fan`` and the fan
paths of ``core.engine``) on the CPU: their own invariants, and three
layers of parity with the JAX package.

Corpus: ``tests/test_fan.py``'s three poisson traces (12 jobs, 16 nodes),
the pool ``fcfs,sjf,saf``, its ``NOISY`` spec (runtime noise 0.3, burst
0.5 over 600 s, failures 0.3, seed 7) and its ``DOMAINS`` spec (16
members, 4 failure domains); the port's ``reference`` backend on the CPU
and the JAX package's ``reference`` engine.

The port's own invariants (counterparts of ``tests/test_fan.py``): F=1
and degenerate specs bitwise ``replay_grid``; member 0 exact; the fan
bitwise its own ``materialize_fan`` oracle; prefix stability; the
reductions against a numpy oracle (rtol 1e-6); ``member_uncertainty``
against numpy (rtol 1e-5); grammar, validation, the domain model's five
properties; pruning never changes the winner; ``decide_fan`` F=1 bitwise
``decide``; the twin's confidence stamps.

Parity with the reference, in three layers:
  1. the draws: ``tests/test_torch_prng.py`` (bitwise);
  2. the reference's own ``materialize_fan`` rows replayed by the port's
     ``replay_grid``: start/end times, deadlocks and events identical to
     the reference's ``fan_grid``; member costs rtol 1e-5 (f32 metric
     sums in torch's order, ROADMAP C4); winners identical;
  3. the port's fan end to end against the reference's ``fan_grid``:
     rows bitwise for runtime-noise, failure, domain and burst fans
     (XLA's ``exp`` and ``sin`` are carried in ``prng.exp_f32`` and
     ``prng.sin_f32``), and then times identical; burst fans' winners
     are also compared on their own, every divergent scenario listed
     with its cost gap (none are expected).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cluster_state
from repro.cluster import workload as jwl
from repro.core import fan as jfan
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import parse_pool as jparse
from repro_torch.cluster import workload as twl
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import fan as tfan
from repro_torch.core.des import cvar_tail_count, quantile_index
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.engine import member_uncertainty
from repro_torch.core.fan import (FanSpec, dominance_keep, materialize_fan,
                                  normalize_fan, pruned_fan_grid)
from repro_torch.core.objective import (Distributional, as_distributional,
                                        parse_objective, validate_objective)
from repro_torch.core.policies import parse_pool as tparse
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
TREF = TEngine("reference", device="cpu")
JREF = JEngine("reference")
POOL = tparse("fcfs,sjf,saf")
JPOOL = jparse("fcfs,sjf,saf")
NOISY_KW = dict(n=8, runtime_noise=0.3, burst_amplitude=0.5,
                burst_period=600.0, failure_prob=0.3, seed=7)
DOMAINS_KW = dict(n=16, failure_prob=0.4, failure_frac=0.5,
                  failure_domains=4, seed=11)
NOISY = FanSpec(**NOISY_KW)
DOMAINS = FanSpec(**DOMAINS_KW)


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


# ----------------------------------------------------------------------
# degenerate parity: F=1 and degenerate fans are the plain replay
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", [FanSpec(n=1),
                                  dataclasses.replace(NOISY, n=1),
                                  dataclasses.replace(DOMAINS, n=1)],
                         ids=["plain", "noisy", "domains"])
def test_f1_fan_is_bitwise_replay_grid(scen, spec):
    base = TREF.replay_grid(scen, POOL.spec)
    fan = TREF.fan_grid(scen, POOL.spec, spec)
    _eq(base.costs, fan.costs)
    _eq(base.best, fan.best)
    _eq(base.start_t, fan.start_t[:, 0])
    _eq(base.end_t, fan.end_t[:, 0])
    for field, a, b in zip(base.metrics._fields, base.metrics, fan.metrics):
        _eq(a, b[:, 0], field)


def test_degenerate_members_all_equal_base(scen):
    base = TREF.replay_grid(scen, POOL.spec)
    fan = TREF.fan_grid(scen, POOL.spec, FanSpec(n=4))
    for phi in range(4):
        _eq(fan.member_costs[:, phi], base.costs)


@pytest.mark.parametrize("spec", [NOISY, DOMAINS], ids=["noisy", "domains"])
def test_member_zero_exact_under_noise(scen, spec):
    base = TREF.replay_grid(scen, POOL.spec)
    fan = TREF.fan_grid(scen, POOL.spec, spec)
    _eq(fan.member_costs[:, 0], base.costs)


# ----------------------------------------------------------------------
# the port's fan against its own materialized oracle; prefixes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", [NOISY, DOMAINS], ids=["noisy", "domains"])
def test_fan_matches_materialized_oracle_bitwise(scen, spec):
    fan = TREF.fan_grid(scen, POOL.spec, spec, "avg_wait")
    mat = TREF.replay_grid(materialize_fan(scen, spec, device="cpu"),
                           POOL.spec,
                           "avg_wait")
    S, F, P = fan.member_costs.shape
    _eq(mat.costs.reshape(S, F, P), fan.member_costs)
    _eq(mat.start_t.reshape(S, F, P, -1), fan.start_t)


@pytest.mark.parametrize("spec", [NOISY, DOMAINS], ids=["noisy", "domains"])
def test_member_keys_are_prefix_stable(scen, spec):
    full = TREF.fan_grid(scen, POOL.spec, spec, "p95:avg_wait")
    f4 = TREF.fan_grid(scen, POOL.spec, dataclasses.replace(spec, n=4),
                       "p95:avg_wait")
    _eq(f4.member_costs, full.member_costs[:, :4])


def test_batching_does_not_leak_into_keys(scen):
    """A 64-member fan's first 8 members are bitwise an 8-member fan,
    and a fan window is bitwise the same slice of the full fan (scenario
    2 alone, under FCFS: the members' keys still carry s = 0)."""
    one = dataclasses.replace(scen, **{
        f: getattr(scen, f)[2:] for f in (
            "submit_t", "nodes", "est_runtime", "true_runtime", "valid",
            "n_jobs", "total_nodes")})
    fcfs = tparse("fcfs").spec
    spec = dataclasses.replace(NOISY, n=64)
    f64 = TREF.fan_grid(one, fcfs, spec, "avg_wait")
    f8 = TREF.fan_grid(one, fcfs, dataclasses.replace(spec, n=8),
                       "avg_wait")
    win = TREF.fan_window_grid(one, fcfs, spec, "avg_wait", lo=40,
                               width=9)
    _eq(f8.member_costs, f64.member_costs[:, :8])
    _eq(f8.end_t, f64.end_t[:, :8])
    _eq(win.member_costs, f64.member_costs[:, 40:49])
    _eq(win.start_t, f64.start_t[:, 40:49])


# ----------------------------------------------------------------------
# reductions and uncertainty against numpy
# ----------------------------------------------------------------------

def _np_reduce(obj, member):
    F = member.shape[1]
    if obj.reduction == "mean":
        return member.mean(axis=1)
    if obj.reduction == "worst":
        return member.max(axis=1)
    if obj.reduction == "regret":
        with np.errstate(invalid="ignore"):
            best = member.min(axis=2, keepdims=True)
            reg = np.where(np.isfinite(member), member - best, np.inf)
        return reg.max(axis=1)
    srt = np.sort(member, axis=1)
    if obj.reduction == "quantile":
        return srt[:, quantile_index(obj.level / 100.0, F)]
    m = cvar_tail_count(obj.level, F)
    return srt[:, F - m:].mean(axis=1)


@pytest.mark.parametrize("goal", [
    "p50:avg_wait", "p95:avg_wait", "p99:avg_wait", "cvar:0.9:avg_wait",
    "cvar:0.5:score", "worst:avg_slowdown", "regret:avg_wait",
    "mean:avg_wait"])
def test_device_reduction_matches_numpy_oracle(scen, goal):
    obj = parse_objective(goal)
    out = TREF.fan_grid(scen, POOL.spec, NOISY, obj)
    oracle = _np_reduce(obj, _np(out.member_costs))
    np.testing.assert_allclose(_np(out.costs), oracle, rtol=1e-6, atol=0)
    _eq(out.best, np.argmin(oracle, axis=1))


def test_member_uncertainty_oracle():
    rng = np.random.default_rng(0)
    member = rng.normal(100.0, 10.0, size=(4, 16, 3)).astype(np.float32)
    member[2, 5, 1] = np.inf
    ci, width = (_np(x) for x in member_uncertainty(torch.tensor(member)))
    with np.errstate(invalid="ignore"):
        exp_ci = 1.96 * member.std(axis=1) / np.sqrt(16)
        exp_w = member.max(axis=1) - member.min(axis=1)
    fin = np.isfinite(member).all(axis=1)
    np.testing.assert_allclose(ci[fin], exp_ci[fin], rtol=1e-5)
    np.testing.assert_allclose(width[fin], exp_w[fin], rtol=1e-5)
    assert np.isinf(ci[~fin]).all() and np.isinf(width[~fin]).all()


def test_member_uncertainty_matches_reference():
    from repro.core.engine import member_uncertainty as jmu
    rng = np.random.default_rng(1)
    member = rng.gamma(2.0, 50.0, size=(3, 8, 5)).astype(np.float32)
    member[0, 3, 2] = np.inf
    for axis in (-2, 0):
        jci, jw = jmu(jnp.asarray(member), axis=axis)
        tci, tw = member_uncertainty(torch.tensor(member), axis=axis)
        np.testing.assert_allclose(_np(tci), np.asarray(jci), rtol=RTOL)
        _eq(tw, jw)


# ----------------------------------------------------------------------
# grammar and validation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "p95:avg_wait", "p99.9:avg_wait", "cvar:0.9:avg_wait", "worst:score",
    "regret:avg_wait", "mean:score", "p50:0.5*avg_wait+0.5*makespan",
    "cvar:0.95:min:avg_wait@util>=0.5", "worst:lex:avg_wait,makespan"])
def test_grammar_round_trip(spec):
    assert isinstance(validate_objective(spec), Distributional)


@pytest.mark.parametrize("bad", [
    "p95:p99:avg_wait", "mean:worst:score", "cvar:1.5:score", "p0:score",
    "cvar:score", "worst:"])
def test_grammar_rejects(bad):
    with pytest.raises(ValueError):
        parse_objective(bad)


def test_plain_goal_lifts_to_mean():
    obj = as_distributional("avg_wait")
    assert obj.reduction == "mean" and obj.inner == parse_objective(
        "avg_wait")
    assert as_distributional(obj) is obj


def test_fanspec_validation():
    for bad in (dict(n=0), dict(n=2, burst_amplitude=1.0),
                dict(n=2, failure_prob=1.5), dict(n=2, runtime_noise=-0.1),
                dict(n=2, burst_period=0.0), dict(n=2, failure_frac=2.0),
                dict(n=4, failure_domains=-1)):
        with pytest.raises(ValueError):
            FanSpec(**bad)
    assert normalize_fan(4) == FanSpec(n=4)
    assert normalize_fan(NOISY) is NOISY
    assert FanSpec(n=3).degenerate and not NOISY.degenerate
    # the same fields and defaults as the reference's spec
    assert [f.name for f in dataclasses.fields(FanSpec)] == [
        f.name for f in dataclasses.fields(jfan.FanSpec)]
    assert dataclasses.asdict(FanSpec()) == dataclasses.asdict(
        jfan.FanSpec())


# ----------------------------------------------------------------------
# pruning
# ----------------------------------------------------------------------

_PRUNE_GOALS = ("mean:avg_wait", "worst:avg_wait", "p50:avg_wait",
                "p95:avg_wait", "cvar:0.7:avg_wait", "regret:avg_wait")


@pytest.mark.parametrize("goal", _PRUNE_GOALS)
def test_prune_winner_invariance_random_tensors(goal):
    obj = parse_objective(goal)
    rng = np.random.default_rng(42)
    for trial in range(200):
        S, F, P = (int(rng.integers(1, n)) for n in (4, 9, 7))
        member = np.round(rng.normal(0.0, 1.0, size=(S, F, P)), 1)
        if trial % 3 == 0:
            member = np.where(rng.random(member.shape) < 0.1, np.inf,
                              member)
        full = _np_reduce(obj, member)
        best_full = np.argmin(full, axis=1)
        keep = dominance_keep(member,
                              pointwise=(obj.reduction == "regret"))
        keep_idx = np.nonzero(keep)[0]
        assert keep[best_full].all(), "winner was pruned"
        sub = _np_reduce(obj, member[:, :, keep_idx])
        _eq(keep_idx[np.argmin(sub, axis=1)], best_full)
        _eq(keep, jfan.dominance_keep(
            member, pointwise=(obj.reduction == "regret")))


@pytest.mark.parametrize("goal", ["p95:avg_wait", "cvar:0.9:score",
                                  "regret:avg_wait"])
def test_pruned_fan_grid_end_to_end(scen, goal):
    full = TREF.fan_grid(scen, POOL.spec, NOISY, goal)
    out, info = pruned_fan_grid(scen, POOL.spec, NOISY, goal, engine=TREF,
                                pre_n=NOISY.n)
    _eq(info.best, full.best)
    _eq(out.member_costs, full.member_costs[:, :, info.keep])
    assert 0.0 <= info.rate < 1.0
    assert info.pre_members.shape == tuple(full.member_costs.shape)


def test_pruned_fan_grid_donates_the_prefix(scen):
    """pre_n < F: the suffix window over the kept pool concatenated with
    the donated pre-pass is the full fan's kept columns, bitwise."""
    spec = dataclasses.replace(NOISY, n=12)
    full = TREF.fan_grid(scen, POOL.spec, spec, "p95:avg_wait")
    out, info = pruned_fan_grid(scen, POOL.spec, spec, "p95:avg_wait",
                                engine=TREF, pre_n=4)
    _eq(out.member_costs, full.member_costs[:, :, info.keep])
    _eq(out.end_t, full.end_t[:, :, info.keep])
    S, P = 3, 3
    assert info.members == S * (4 * P + 8 * len(info.keep))
    assert info.members_full == S * 12 * P


# ----------------------------------------------------------------------
# decide_fan and the twin
# ----------------------------------------------------------------------

def _states(n=4, **kw):
    out = []
    for seed in range(n):
        js = make_cluster_state(max_jobs=48, total_nodes=32, seed=seed,
                                n_queued=6 + seed, n_running=2,
                                now=100.0 + 40.0 * seed, **kw)
        out.append((js, state_from_numpy(state_to_numpy(js), device="cpu")))
    return out


IDS = torch.tensor([0, 1, 2], dtype=torch.int32)
JIDS = jnp.asarray([0, 1, 2], jnp.int32)


@pytest.mark.parametrize("spec", [FanSpec(n=1), 4,
                                  dataclasses.replace(NOISY, n=1),
                                  dataclasses.replace(DOMAINS, n=1)],
                         ids=["f1", "degenerate4", "noisy1", "domains1"])
def test_decide_fan_f1_is_bitwise_decide(spec):
    for _, state in _states():
        d0 = TREF.decide(state, IDS)
        d1 = TREF.decide_fan(state, IDS, spec)
        assert int(d0.policy_index) == int(d1.policy_index)
        _eq(d0.costs, d1.costs)
        _eq(d0.run_mask, d1.run_mask)


def test_decide_fan_stamps_uncertainty():
    _, state = _states(1)[0]
    d = TREF.decide_fan(state, IDS, FanSpec(n=8, runtime_noise=0.3),
                        "p95:avg_wait")
    assert d.fan_size == 8
    ci, width = _np(d.cost_ci), _np(d.fan_width)
    assert ci.shape == width.shape == (3,)
    assert (ci[np.isfinite(ci)] >= 0).all()
    assert (width[np.isfinite(width)] >= 0).all()
    d0 = TREF.decide(state, IDS)
    assert d0.fan_size == 1 and d0.cost_ci is None


@pytest.mark.parametrize("kw", [
    dict(n=8, runtime_noise=0.3), dict(n=8, failure_prob=0.5),
    dict(n=16, failure_prob=0.4, failure_domains=4, seed=3),
    dict(n=8, runtime_noise=0.5, failure_prob=0.3, seed=7)],
    ids=["noise", "fail", "domains", "both"])
@pytest.mark.parametrize("goal", ["score", "p95:avg_wait"])
def test_decide_fan_matches_reference(kw, goal):
    """Drain-side fans: the member perturbations are bitwise the
    reference's, so the winner, the qrun set and the deadlocks are
    identical and the costs and CI stamps agree to C4's rtol (the spread,
    a difference of two costs, to 1e-4)."""
    for js, ts in _states(4):
        jd = JREF.decide_fan(js, JIDS, jfan.FanSpec(**kw), goal)
        td = TREF.decide_fan(ts, IDS, FanSpec(**kw), goal)
        assert int(td.policy_index) == int(jd.policy_index)
        _eq(td.run_mask, jd.run_mask)
        _eq(td.deadlocked, jd.deadlocked)
        np.testing.assert_allclose(_np(td.costs), np.asarray(jd.costs),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(td.cost_ci), np.asarray(jd.cost_ci),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(td.fan_width),
                                   np.asarray(jd.fan_width), rtol=1e-4)
        assert td.fan_size == jd.fan_size


def test_twin_records_fan_confidence():
    from repro_torch.cluster.emulator import ClusterEmulator
    from repro_torch.core.events import EventBus
    from repro_torch.core.twin import SchedTwin
    trace = twl.poisson_trace(10, 16, 20.0, (1, 4), (30.0, 300.0), seed=1)
    bus = EventBus()
    em = ClusterEmulator(trace, 16, bus=bus, engine=TREF)
    twin = SchedTwin(bus=bus, qrun=em.qrun, total_nodes=16,
                     max_jobs=em.max_jobs, engine=TREF,
                     fan=FanSpec(n=4, runtime_noise=0.3),
                     objective="p95:avg_wait",
                     free_nodes_probe=lambda: em.free_nodes)
    em.run(on_event=twin.pump)
    assert twin.telemetry.cycles, "no decision cycles ran"
    rec = twin.telemetry.cycles[0]
    assert rec.fan_size == 4 and rec.cost_ci and rec.fan_width
    stats = twin.telemetry.confidence_stats()
    assert stats and all(st["n"] + st["n_inf"] > 0
                         for st in stats.values())


def test_twin_rejects_fan_plus_ensemble():
    from repro_torch.core.events import EventBus
    from repro_torch.core.twin import SchedTwin
    with pytest.raises(ValueError, match="mutually exclusive"):
        SchedTwin(bus=EventBus(), qrun=lambda j, t: None, total_nodes=8,
                  fan=FanSpec(n=4), ensemble=4, device="cpu")


# ----------------------------------------------------------------------
# the correlated failure-domain model
# ----------------------------------------------------------------------

def _domain_draws(spec, S, F, tot):
    idx = torch.arange(S * F)
    s, phi = idx // F, idx % F
    _, _, u = tfan._member_draws(spec.seed, s, phi, 4)
    q = _np(tfan._domain_fragility(spec.seed, torch.arange(S),
                                   spec.failure_domains))
    return s, phi, u, torch.full((S * F,), tot, dtype=torch.int32), q


def test_domain_downs_are_quantized_capacity_levels():
    S, F, tot = 5, 32, 61
    s, phi, u, totv, _ = _domain_draws(DOMAINS, S, F, tot)
    down = _np(tfan.failure_downs(DOMAINS, s, phi, u, totv))
    D = DOMAINS.failure_domains
    levels = {min(int(np.float32(tot) * k / D),
                  int(np.float32(tot) * DOMAINS.failure_frac))
              for k in range(D + 1)}
    assert set(down.tolist()) <= levels
    assert len(set(down.tolist())) > 1


def test_domain_failure_sets_are_nested_across_members():
    S, F, tot = 4, 64, 64
    s, phi, u, totv, _ = _domain_draws(DOMAINS, S, F, tot)
    down = _np(tfan.failure_downs(DOMAINS, s, phi, u, totv))
    u0, s, phi = _np(u)[:, 0], _np(s), _np(phi)
    for sc in range(S):
        rows = [i for i in range(S * F) if s[i] == sc and phi[i] > 0]
        losses = [down[i] for i in sorted(rows, key=lambda i: u0[i])]
        assert all(a >= b for a, b in zip(losses, losses[1:]))


def test_domain_fragility_is_member_and_fan_independent():
    q1 = tfan._domain_fragility(11, torch.tensor([2]), 4)
    q2 = tfan._domain_fragility(11, torch.tensor([2]), 4)
    _eq(q1, q2)
    assert not np.array_equal(
        _np(q1), _np(tfan._domain_fragility(11, torch.tensor([3]), 4)))


def test_domain_marginal_rate_is_failure_prob():
    q = _np(tfan._domain_fragility(11, torch.arange(4000), 8))
    assert abs(np.minimum(2.0 * 0.3 * q, 1.0).mean() - 0.3) < 0.01


def test_failure_downs_match_reference():
    """Both failure models, row for row, against the reference's."""
    import jax
    for spec_kw in (dict(n=8, failure_prob=0.4, failure_frac=0.5, seed=11),
                    DOMAINS_KW):
        S, F, tot = 5, 16, 61
        s, phi, u, totv, _ = _domain_draws(FanSpec(**spec_kw), S, F, tot)
        js, jphi = jnp.asarray(_np(s)), jnp.asarray(_np(phi))
        _, _, ju = jax.vmap(lambda a, b: jfan._member_draws(
            spec_kw["seed"], a, b, 4))(js, jphi)
        want = jfan.failure_downs(jfan.FanSpec(**spec_kw), js, jphi, ju,
                                  jnp.full((S * F,), tot, jnp.int32))
        _eq(tfan.failure_downs(FanSpec(**spec_kw), s, phi, u, totv), want)


# ----------------------------------------------------------------------
# parity with the reference's fan_grid
# ----------------------------------------------------------------------

def _assert_times_equal(port, ref, ctx):
    _eq(port.start_t, ref.start_t, f"{ctx} start_t")
    _eq(port.end_t, ref.end_t, f"{ctx} end_t")
    _eq(port.deadlocked, ref.deadlocked, f"{ctx} deadlocked")
    _eq(port.events, ref.events, f"{ctx} events")


@pytest.mark.parametrize("kw", [NOISY_KW, DOMAINS_KW,
                                dict(n=8, runtime_noise=0.5, seed=2)],
                         ids=["noisy", "domains", "noise"])
def test_reference_rows_replayed_by_the_port(scen, jscen, kw):
    """Layer 2: the reference's own perturbed rows (its host oracle)
    through the port's ``replay_grid`` are its ``fan_grid``."""
    goal = "p95:avg_wait"
    jfan_out = JREF.fan_grid(jscen, JPOOL.spec, jfan.FanSpec(**kw), goal)
    rows = jfan.materialize_fan(jscen, jfan.FanSpec(**kw))
    mat = TREF.replay_grid(rows, POOL.spec, "avg_wait")
    S, F, P = np.asarray(jfan_out.member_costs).shape
    shape = lambda x: _np(x).reshape((S, F, P) + _np(x).shape[2:])  # noqa
    _eq(shape(mat.start_t), jfan_out.start_t, "start_t")
    _eq(shape(mat.end_t), jfan_out.end_t, "end_t")
    _eq(shape(mat.deadlocked), jfan_out.deadlocked, "deadlocked")
    _eq(shape(mat.events), jfan_out.events, "events")
    np.testing.assert_allclose(shape(mat.costs),
                               np.asarray(jfan_out.member_costs),
                               rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(n=8, failure_prob=0.3, seed=7), DOMAINS_KW,
    dict(n=8, runtime_noise=0.3, seed=7),
    dict(n=8, runtime_noise=0.4, failure_prob=0.2, seed=5)],
    ids=["failure", "domains", "noise", "noise_failure"])
@pytest.mark.parametrize("goal", ["p95:avg_wait", "cvar:0.9:score"])
def test_fan_grid_bitwise_reference(scen, jscen, kw, goal):
    """Layer 3, exact models: the port's rows are the reference's bit for
    bit, so the whole fan's times are identical and its selection
    agrees (costs to C4's rtol, winners identical)."""
    _assert_fan_bitwise(scen, jscen, kw, goal)


def _assert_fan_bitwise(scen, jscen, kw, goal):
    j = JREF.fan_grid(jscen, JPOOL.spec, jfan.FanSpec(**kw), goal)
    t = TREF.fan_grid(scen, POOL.spec, FanSpec(**kw), goal)
    _assert_times_equal(t, j, str(kw))
    jrows = jfan.materialize_fan(jscen, jfan.FanSpec(**kw))
    trows = materialize_fan(scen, FanSpec(**kw), device="cpu")
    for f in ("submit_t", "true_runtime", "total_nodes", "valid"):
        _eq(getattr(trows, f), getattr(jrows, f), f)
    np.testing.assert_allclose(_np(t.member_costs),
                               np.asarray(j.member_costs), rtol=RTOL)
    np.testing.assert_allclose(_np(t.costs), np.asarray(j.costs), rtol=RTOL)
    _eq(t.best, j.best)


@pytest.mark.parametrize("kw", [NOISY_KW,
                                dict(n=16, burst_amplitude=0.3,
                                     burst_period=900.0, seed=1)],
                         ids=["noisy", "burst"])
@pytest.mark.parametrize("goal", ["p95:avg_wait", "cvar:0.9:score",
                                  "mean:score"])
def test_burst_fan_winners_match_reference(scen, jscen, kw, goal):
    """Layer 3, burst warps: the winners are compared on their own; a
    divergent scenario would be listed with its cost gap."""
    j = JREF.fan_grid(jscen, JPOOL.spec, jfan.FanSpec(**kw), goal)
    t = TREF.fan_grid(scen, POOL.spec, FanSpec(**kw), goal)
    jb, tb = np.asarray(j.best), _np(t.best)
    jc = np.asarray(j.costs)
    div = [(s, int(jb[s]), int(tb[s]),
            float(jc[s, tb[s]] - jc[s, jb[s]]))
           for s in range(len(jb)) if jb[s] != tb[s]]
    assert not div, f"divergent winners (scenario, ref, port, gap): {div}"
    np.testing.assert_allclose(_np(t.costs), jc, rtol=1e-3)


@pytest.mark.parametrize("kw", [NOISY_KW,
                                dict(n=16, burst_amplitude=0.3,
                                     burst_period=900.0, seed=1),
                                dict(n=8, burst_amplitude=0.9,
                                     burst_period=600.0, seed=3)],
                         ids=["noisy", "burst", "burst_strong"])
@pytest.mark.parametrize("goal", ["p95:avg_wait", "cvar:0.9:score",
                                  "mean:score"])
def test_burst_fan_grid_bitwise_reference(scen, jscen, kw, goal):
    """Layer 3, burst warps (C11 repaired): the warped arrivals are the
    reference's bit for bit (``prng.sin_f32`` is XLA's ``sin``), so the
    rows, times and winners are identical, as for the other models."""
    _assert_fan_bitwise(scen, jscen, kw, goal)
