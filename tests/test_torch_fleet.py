"""The port's fleet engine (block streaming and shards) on the CPU.

Ports ``tests/test_fleet.py``'s 14 tests and the sharded tests of
``test_fan.py``, ``test_race.py``, ``test_learn.py``,
``test_objective.py``, ``test_policyspec.py`` and ``test_replay.py``.
The JAX sharded entries fail on this jax (``lax.cond`` under
``shard_map``), so the port is held against the JAX SINGLE-SHOT entries
(``replay_grid``, ``fan_grid``, ``race_grid``, ``decide``,
``generation_costs``) on the same numpy ``ScenarioSet``s — the
``reference`` engine, plus the Pallas kernel in interpret mode on two
combos — and against its own single-shot paths.

Meshes are ``FleetMesh``es of 1, 2 and 3 CPU shards (the CPU named
more than once: the counterpart of the reference's forced host device
count).

Tolerances:
  * against the port's own single-shot grids and decisions: every field
    identical, metrics and costs included, at every block size (1, 2,
    None), prefetch depth (0, 2), source (a set, an iterable of blocks)
    and shard count tried;
  * against JAX: ``start_t``, ``end_t``, ``deadlocked``, ``events`` and
    winners identical; metrics and costs ``rtol=1e-5`` (f32 sums in
    torch's order, ROADMAP C4);
  * ``decide_legacy_vmap`` against JAX's: winner, qrun set and deadlocks
    identical, costs ``rtol=1e-5``;
  * ``arch_job_mix`` and the synthetic LM pipeline: identical fields.
"""
import dataclasses
import functools
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cluster_state
from repro.cluster import workload as jwl
from repro.core import race as jrace
from repro.core import whatif as jwhatif
from repro.core.engine import DrainEngine as JEngine
from repro.core.fan import FanSpec as JFanSpec
from repro.core.policies import parse_pool as jparse
from repro.data import pipeline as jpipe
from repro_torch.cluster import workload as twl
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import des, whatif
from repro_torch.core.engine import (_SCENARIO_ARRAY_CACHE, DrainEngine,
                                     _scenario_arrays, shard_local_plan)
from repro_torch.core.fan import FanSpec
from repro_torch.core.policies import FAM_LIN, parse_pool, theta_pool
from repro_torch.core.race import RaceSpec, race_grid
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import prefetch
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
from repro_torch.learn import TrainConfig, family_space, train
from repro_torch.learn.strategy import draw_eps
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
REF = DrainEngine("reference", device="cpu")
JREF = JEngine("reference")
JPAL = JEngine("pallas", interpret=True)
MESH = {n: FleetMesh(["cpu"] * n) for n in (1, 2, 3)}
MIXED = "extended,wfp:a=1..3x3"          # static and time-varying forks


def fleet_traces(wl, n_traces, n_jobs=12, total_nodes=16):
    """``tests/test_fleet.py::fleet_traces`` from package ``wl``."""
    out = []
    for i in range(n_traces):
        gen = wl.bursty_trace if i % 2 else wl.poisson_trace
        out.append(gen(n_jobs, total_nodes, 4.0 + i,
                       (1, total_nodes - 4), (30.0, 400.0), seed=100 + i))
    return out


@pytest.fixture(scope="module")
def scen5():
    return twl.stack_scenarios(fleet_traces(twl, 5), 16, max_jobs=16)


@functools.lru_cache(maxsize=None)
def _jax_grid(grammar, backend="reference", objective=None):
    scen = jwl.stack_scenarios(fleet_traces(jwl, 5), 16, max_jobs=16)
    eng = JREF if backend == "reference" else JPAL
    return eng.replay_grid(scen, jparse(grammar).spec, objective)


@functools.lru_cache(maxsize=None)
def _port_grid(grammar, objective=None):
    scen = twl.stack_scenarios(fleet_traces(twl, 5), 16, max_jobs=16)
    return REF.replay_grid(scen, parse_pool(grammar).spec, objective)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_port_identical(a, b, ctx=""):
    """Two port outcomes: every field, metrics and costs included."""
    for f in ("start_t", "end_t", "deadlocked", "events", "costs", "best"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{ctx}: {f}"
    for f, x in a.metrics._asdict().items():
        assert torch.equal(x, getattr(b.metrics, f)), f"{ctx}: metrics.{f}"


def assert_matches_jax(t, j, ctx=""):
    """A port outcome against a JAX one: times, deadlocks, events and
    winners identical; metrics and costs to ``RTOL``."""
    for f in ("start_t", "end_t", "deadlocked", "events", "best"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{ctx}: {f}")
    for f, x in t.metrics._asdict().items():
        np.testing.assert_allclose(_np(x), np.asarray(getattr(j.metrics, f)),
                                   rtol=RTOL, err_msg=f"{ctx}: metrics.{f}")
    np.testing.assert_allclose(_np(t.costs), np.asarray(j.costs), rtol=RTOL,
                               err_msg=f"{ctx}: costs")


# ----------------------------------------------------------------------
# Sharded == local, hoisting on (JAX reference, and Pallas on two combos).
# ----------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "pallas"],
                         ids=["ref", "pallas"])
def test_sharded_grid_matches_local_with_hoisting(scen5, backend):
    pool = parse_pool(MIXED)
    plan = REF.plan(pool.spec)          # static and time-varying forks
    assert plan is not None and any(plan) and not all(plan)
    sharded = whatif.sharded_replay_grid(MESH[1], engine=REF)(scen5, pool)
    assert_port_identical(sharded, _port_grid(MIXED), "sharded vs local")
    assert_matches_jax(sharded, _jax_grid(MIXED, backend),
                       f"sharded vs JAX {backend}")


def test_sharded_grid_all_static_pool(scen5):
    """plan.all() — the zero-per-event-sort path — under sharding."""
    pool = parse_pool("fcfs,sjf,saf,ljf")
    assert all(REF.plan(pool.spec))
    sharded = whatif.sharded_replay_grid(MESH[2], engine=REF,
                                         block_size=2)(scen5, pool)
    assert_port_identical(sharded, _port_grid("fcfs,sjf,saf,ljf"),
                          "all-static")
    assert_matches_jax(sharded, _jax_grid("fcfs,sjf,saf,ljf"), "all-static")


def test_sharded_grid_pallas_all_static(scen5):
    """The second Pallas combo: the all-static pool, streamed in blocks
    of one scenario, against the JAX kernel in interpret mode."""
    pool = parse_pool("fcfs,sjf,saf,ljf")
    got = whatif.sharded_replay_grid(MESH[1], engine=REF,
                                     block_size=1)(scen5, pool)
    assert_matches_jax(got, _jax_grid("fcfs,sjf,saf,ljf", "pallas"),
                       "all-static vs JAX pallas")


# ----------------------------------------------------------------------
# Block streaming + padding.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 2, None])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_block_streamed_equals_single_shot(scen5, block, depth, shards):
    """Every block size, prefetch depth and shard count gives the
    one-shot grid's bits; iterations and passes sum over (shard,
    block), so they grow with the pieces."""
    pool = parse_pool("extended")
    one = _port_grid("extended")
    blk = whatif.sharded_replay_grid(MESH[shards], engine=REF,
                                     block_size=block,
                                     prefetch_depth=depth)(scen5, pool)
    assert_port_identical(blk, one, f"block {block} depth {depth}")
    assert blk.start_t.shape[:2] == (5, 7)
    pieces = -(-5 // (block or 5)) if block else 1
    assert int(blk.result.iters) >= int(one.result.iters)
    if pieces == 1 and shards == 1:
        assert int(blk.result.iters) == int(one.result.iters)
        assert int(blk.result.pass_invocations) == \
            int(one.result.pass_invocations)


def test_padding_invariance_non_divisible(scen5):
    """S=5 into B=2 blocks: the last block is padded with an inert row;
    every real row is bitwise the unpadded local grid's, padded rows do
    not leak into the outcome, and the JAX grid agrees."""
    pool = parse_pool("extended")
    blk = whatif.sharded_replay_grid(MESH[1], engine=REF,
                                     block_size=2)(scen5, pool)
    assert blk.costs.shape == (5, 7)
    assert blk.best.shape == (5,)
    assert blk.result.state.jobs.state.shape[0] == 5 * 7
    assert_port_identical(blk, _port_grid("extended"), "padded vs local")
    assert_matches_jax(blk, _jax_grid("extended"), "padded vs JAX")


def test_overlap_determinism(scen5):
    pool = parse_pool("extended")
    d0 = whatif.sharded_replay_grid(MESH[1], engine=REF, block_size=2,
                                    prefetch_depth=0)(scen5, pool)
    d2 = whatif.sharded_replay_grid(MESH[1], engine=REF, block_size=2,
                                    prefetch_depth=2)(scen5, pool)
    assert_port_identical(d0, d2, "depth 0 vs depth 2")
    assert int(d0.result.iters) == int(d2.result.iters)


@pytest.mark.parametrize("shards", [1, 2])
def test_iterator_block_source(scen5, shards):
    """Pre-cut block iterables (on-the-fly trace synthesis) match the
    ScenarioSet path — including a ragged final block."""
    pool = parse_pool("extended")
    whole = whatif.sharded_replay_grid(MESH[shards], engine=REF,
                                       block_size=2)(scen5, pool)
    blocks = (twl.slice_scenarios(scen5, lo, min(lo + 2, 5))
              for lo in range(0, 5, 2))
    streamed = whatif.sharded_replay_grid(MESH[shards], engine=REF,
                                          block_size=2)(blocks, pool)
    assert_port_identical(streamed, whole, "iterator vs set")
    assert_port_identical(streamed, _port_grid("extended"),
                          "iterator vs one-shot")


def test_iterator_source_errors(scen5):
    pool = parse_pool("extended")
    run = whatif.sharded_replay_grid(MESH[1], engine=REF, block_size=2)
    with pytest.raises(ValueError, match="no scenario blocks"):
        run(iter(()), pool)
    with pytest.raises(ValueError, match="block size"):
        run(iter([scen5]), pool)                 # 5 scenarios > B=2
    with pytest.raises(ValueError, match="block size"):
        whatif.sharded_replay_grid(MESH[1], engine=REF, block_size=2,
                                   prefetch_depth=0)(iter([scen5]), pool)


def test_pad_scenarios_semantics(scen5):
    assert twl.pad_scenarios(scen5, 5) is scen5   # identity on divide
    padded = twl.pad_scenarios(scen5, 3)
    assert padded.n_scenarios == 6
    assert not padded.valid[5:].any()             # inert: born drained
    np.testing.assert_array_equal(padded.submit_t[:5], scen5.submit_t)
    with pytest.raises(ValueError, match="positive"):
        twl.pad_scenarios(scen5, 0)


# ----------------------------------------------------------------------
# Host-side machinery: prefetch errors, conversion cache, local plans.
# ----------------------------------------------------------------------

def test_prefetch_propagates_worker_errors():
    def boom():
        yield 1
        raise RuntimeError("ingest failed")
    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="ingest failed"):
        next(it)
    assert list(prefetch(iter(range(7)), depth=1)) == list(range(7))


def test_scenario_array_cache_hit_and_eviction(scen5):
    scen = twl.stack_scenarios(fleet_traces(twl, 2, n_jobs=6), 16,
                               max_jobs=8)
    cpu = torch.device("cpu")
    first = _scenario_arrays(scen, cpu)
    again = _scenario_arrays(scen, cpu)
    assert all(x is y for x, y in zip(first, again))   # cache hit
    key = (id(scen), str(cpu))
    assert key in _SCENARIO_ARRAY_CACHE
    del scen, first, again
    gc.collect()
    assert key not in _SCENARIO_ARRAY_CACHE            # finalizer ran
    # a stream converts its padded blocks uncached: the memo never grows
    before = len(_SCENARIO_ARRAY_CACHE)
    whatif.sharded_replay_grid(MESH[2], engine=REF, block_size=2)(
        scen5, parse_pool("paper"))
    gc.collect()
    assert len(_SCENARIO_ARRAY_CACHE) == before


def test_shard_local_plan():
    assert shard_local_plan(None, 4) is None
    plan = (True, False, True, False)
    assert shard_local_plan(plan, 1) == plan           # no sharding
    assert shard_local_plan(plan, 2) == (True, False)  # periodic
    assert shard_local_plan((True, False, False, True), 2) is None
    assert shard_local_plan((True, False, True), 2) is None   # 3 % 2
    assert shard_local_plan((False, False), 2) is None  # nothing to hoist


def test_make_fleet_mesh_bounds():
    """A ``FleetMesh`` holds one device per shard on a ``data`` axis;
    ``make_fleet_mesh`` takes CUDA cards only (bounds checked on a card
    in ``tests/test_torch_cuda.py``) and raises without one."""
    mesh = FleetMesh(["cpu", torch.device("cpu")])
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.home == torch.device("cpu")
    with pytest.raises(ValueError, match="at least one"):
        FleetMesh([])
    for entry in (whatif.sharded_whatif, whatif.sharded_replay_grid,
                  whatif.sharded_fan_grid, whatif.sharded_race_grid):
        with pytest.raises(ValueError, match="'data' axis only"):
            entry(mesh, "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_fleet_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetMesh(["cuda:1"])


# ----------------------------------------------------------------------
# sharded_whatif: hoisting parity + divisibility contract.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decide_state():
    js = make_cluster_state(max_jobs=16, total_nodes=32, n_queued=8,
                            n_running=3, seed=4)
    return js, state_from_numpy(state_to_numpy(js), device="cpu")


@pytest.mark.parametrize("grammar,shards", [
    ("fcfs,sjf", 1), ("fcfs,sjf", 2), (MIXED, 1), (MIXED, 2),
    ("extended,wfp:a=1..2x2", 3)])
def test_sharded_whatif_hoist_parity(grammar, shards):
    js, ts = _decide_state()
    pool = parse_pool(grammar)
    ref = REF.decide(ts, pool.spec)
    got = whatif.sharded_whatif(MESH[shards], engine=REF)(ts, pool)
    for f in ("policy_index", "costs", "run_mask", "deadlocked"):
        assert torch.equal(getattr(ref, f), getattr(got, f)), f
    for f, x in ref.metrics._asdict().items():
        assert torch.equal(x, getattr(got.metrics, f)), f
    j = JREF.decide(js, jparse(grammar).spec)
    assert int(got.policy_index) == int(j.policy_index)
    np.testing.assert_array_equal(_np(got.run_mask), np.asarray(j.run_mask))
    np.testing.assert_array_equal(_np(got.deadlocked),
                                  np.asarray(j.deadlocked))
    np.testing.assert_allclose(_np(got.costs), np.asarray(j.costs),
                               rtol=RTOL)


def test_sharded_whatif_divisibility():
    _, ts = _decide_state()
    run = whatif.sharded_whatif(MESH[2], engine=REF)
    with pytest.raises(ValueError, match="not divisible"):
        run(ts, "paper")                             # k=3 over 2 shards


# ----------------------------------------------------------------------
# Real ≥2-shard parity (the reference's subprocess test: here the CPU
# named twice or three times).
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("grammar", ["fcfs,sjf", "wfp,expf,fcfs,sjf"])
def test_multi_shard_parity(shards, grammar):
    traces = [twl.poisson_trace(8, 16, 4.0 + i, (1, 12), (30.0, 400.0),
                                seed=100 + i) for i in range(3)]
    scen = twl.stack_scenarios(traces, 16, max_jobs=16)
    pool = parse_pool(grammar)
    ref = REF.replay_grid(scen, pool.spec)
    for bs in (None, 2):
        got = whatif.sharded_replay_grid(MESH[shards], engine=REF,
                                         block_size=bs)(scen, pool)
        assert_port_identical(got, ref, f"{grammar} bs={bs}")


# ----------------------------------------------------------------------
# Fans, races, generation costs, goals, spec pools (the sharded tests of
# the other JAX files).
# ----------------------------------------------------------------------

POOL3 = parse_pool("fcfs,sjf,saf")
NOISY_KW = dict(n=8, runtime_noise=0.3, burst_amplitude=0.5,
                burst_period=600.0, failure_prob=0.3, seed=7)


def _fan_traces(wl):
    return [wl.poisson_trace(12, 16, 30.0, (1, 4), (60.0, 600.0), seed=s)
            for s in range(3)]


@pytest.fixture(scope="module")
def fscen():
    return twl.stack_scenarios(_fan_traces(twl), total_nodes=16)


@functools.lru_cache(maxsize=None)
def _fans():
    """(port one-shot fan, JAX one-shot fan) of ``NOISY_KW``."""
    scen = twl.stack_scenarios(_fan_traces(twl), total_nodes=16)
    jscen = jwl.stack_scenarios(_fan_traces(jwl), total_nodes=16)
    return (REF.fan_grid(scen, POOL3.spec, FanSpec(**NOISY_KW),
                         "p95:avg_wait"),
            JREF.fan_grid(jscen, jparse("fcfs,sjf,saf").spec,
                          JFanSpec(**NOISY_KW), "p95:avg_wait"))


@pytest.mark.parametrize("shards,block", [(1, None), (1, 6), (2, 8)])
def test_sharded_fan_grid_matches_local(fscen, shards, block):
    local, j = _fans()
    got = whatif.sharded_fan_grid(
        MESH[shards], engine=REF, objective="p95:avg_wait",
        fan=FanSpec(**NOISY_KW), block_size=block)(fscen, POOL3)
    for f in ("start_t", "end_t", "deadlocked", "events", "member_costs",
              "costs", "best", "cost_ci", "fan_width"):
        assert torch.equal(getattr(local, f), getattr(got, f)), \
            f"block={block}: {f}"
    for f in ("start_t", "end_t", "deadlocked", "events", "best"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("member_costs", "costs"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(j, f)), rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _races():
    """(port ``race_grid``, JAX ``race_grid``) from F0=2 to the NOISY
    fan's F_max=8."""
    scen = twl.stack_scenarios(_fan_traces(twl), total_nodes=16)
    jscen = jwl.stack_scenarios(_fan_traces(jwl), total_nodes=16)
    return (race_grid(scen, POOL3.spec, RaceSpec(fan=FanSpec(**NOISY_KW),
                                                 f0=2),
                      "p95:avg_wait", engine=REF),
            jrace.race_grid(jscen, jparse("fcfs,sjf,saf").spec,
                            jrace.RaceSpec(fan=JFanSpec(**NOISY_KW), f0=2),
                            "p95:avg_wait", engine=JREF))


@pytest.mark.parametrize("shards,block", [(1, None), (2, 4)])
def test_sharded_race_grid_matches_local(fscen, shards, block):
    local, j = _races()
    got = whatif.sharded_race_grid(
        MESH[shards], engine=REF, objective="p95:avg_wait",
        race=RaceSpec(fan=FanSpec(**NOISY_KW), f0=2),
        block_size=block)(fscen, POOL3)
    np.testing.assert_array_equal(local.member_costs, got.member_costs,
                                  err_msg=f"block={block}")
    np.testing.assert_array_equal(local.costs, got.costs)
    np.testing.assert_array_equal(local.best, got.best)
    np.testing.assert_array_equal(local.keep, got.keep)
    assert got.stopped == local.stopped
    assert got.members == local.members
    assert [r.eliminated for r in got.rungs] == \
        [r.eliminated for r in local.rungs]
    np.testing.assert_array_equal(got.best, np.asarray(j.best))
    np.testing.assert_array_equal(got.keep, np.asarray(j.keep))
    assert got.members == j.members and got.stopped == j.stopped


TRACE = lambda wl: (lambda r: wl.poisson_trace(  # noqa: E731
    16, 16, 45.0, (1, 6), (60.0, 900.0), rng=r))


@functools.lru_cache(maxsize=None)
def _split():
    return twl.split_scenarios(np.random.default_rng(3), TRACE(twl), 3, 2, 16)


def test_sharded_generation_costs_bitwise():
    train_scen, _ = _split()
    thetas = family_space("lin").decode(draw_eps(0, 1, 4, 6, True))
    pool = theta_pool(FAM_LIN, thetas)
    local = REF.generation_costs(train_scen, pool.spec, "avg_wait")
    for shards, fan in ((1, None), (2, None), (2, FanSpec(n=2,
                                                          runtime_noise=0.2))):
        run = whatif.sharded_generation_costs(
            MESH[shards], engine=REF, objective="avg_wait", block_size=2,
            fan=fan)
        want = (local if fan is None else
                REF.generation_costs(train_scen, pool.spec, "avg_wait", fan))
        assert torch.equal(run(train_scen, pool.spec), want)
    jtrain = jwl.split_scenarios(np.random.default_rng(3), TRACE(jwl),
                                 3, 2, 16)[0]
    from repro.core.policies import theta_pool as jtheta_pool
    from repro.learn import family_space as jspace
    from repro.learn.strategy import draw_eps as jdraw
    jpool = jtheta_pool(FAM_LIN, jspace("lin").decode(
        jdraw(0, 1, 4, 6, True)))
    np.testing.assert_allclose(
        _np(local), np.asarray(JREF.generation_costs(jtrain, jpool.spec,
                                                     "avg_wait")),
        rtol=RTOL)


def test_train_with_sharded_eval_fn_is_bitwise():
    """``train(..., eval_fn=sharded_generation_costs(...))`` ends at the
    default evaluator's θ, history and held-out cost, bitwise."""
    train_scen, heldout = _split()
    cfg = TrainConfig(family="lin", strategy="cem", population=4,
                      generations=2, objective="avg_wait", seed=5,
                      patience=0)
    base = train(train_scen, heldout, cfg, engine=REF)
    fleet = train(train_scen, heldout, cfg, engine=REF,
                  eval_fn=whatif.sharded_generation_costs(
                      MESH[2], engine=REF, objective="avg_wait",
                      block_size=1))
    np.testing.assert_array_equal(fleet.theta, base.theta)
    assert fleet.best_heldout == base.best_heldout
    assert fleet.history == base.history


def _objective_grid(wl):
    traces = [wl.poisson_trace(14, 32, 8.0, (1, 16), (30.0, 900.0),
                               seed=s) for s in range(2)]
    return wl.stack_scenarios(traces, 32)


def test_sharded_replay_grid_objective():
    scen = _objective_grid(twl)
    pool = parse_pool("extended")
    out = whatif.sharded_replay_grid(MESH[2], "data", engine=REF,
                                     objective="avg_wait")(scen, pool)
    ref = REF.replay_grid(scen, pool.spec, "avg_wait")
    assert torch.equal(out.best, ref.best)
    assert torch.equal(out.costs, ref.costs)
    j = JREF.replay_grid(_objective_grid(jwl), jparse("extended").spec,
                         "avg_wait")
    np.testing.assert_array_equal(_np(out.best), np.asarray(j.best))
    np.testing.assert_allclose(_np(out.costs), np.asarray(j.costs),
                               rtol=RTOL)


def test_sharded_whatif_accepts_spec_pool():
    js = make_cluster_state(max_jobs=64, seed=4)
    ts = state_from_numpy(state_to_numpy(js), device="cpu")
    pool = parse_pool(MIXED)                        # k=10
    for shards in (1, 2):
        d = whatif.sharded_whatif(MESH[shards], engine=REF)(ts, pool)
        assert d.costs.shape == (10,)
        d_ref = REF.decide(ts, pool.spec)
        for f in ("policy_index", "costs", "run_mask", "deadlocked"):
            assert torch.equal(getattr(d, f), getattr(d_ref, f)), f
        assert d.cost_terms.keys() == d_ref.cost_terms.keys()
    j = JREF.decide(js, jparse(MIXED).spec)
    assert int(d.policy_index) == int(j.policy_index)
    np.testing.assert_allclose(_np(d.costs), np.asarray(j.costs), rtol=RTOL)


def test_sharded_replay_grid_matches_jax_replay():
    traces = [twl.poisson_trace(12, 16, 4.0, (1, 12), (30.0, 400.0),
                                seed=100),
              twl.bursty_trace(12, 16, 5.0, (1, 12), (30.0, 400.0),
                               seed=101)]
    scen = twl.stack_scenarios(traces, 16, max_jobs=32)
    pool = parse_pool("extended")
    sharded = whatif.sharded_replay_grid(MESH[2], engine=REF)(scen, pool)
    assert_port_identical(sharded, REF.replay_grid(scen, pool.spec),
                          "sharded vs local")
    jscen = jwl.stack_scenarios(
        [[jwl.JobSpec(**dataclasses.asdict(j)) for j in t] for t in traces],
        16, max_jobs=32)
    assert_matches_jax(sharded, JREF.replay_grid(jscen,
                                                 jparse("extended").spec),
                       "sharded vs JAX")


# ----------------------------------------------------------------------
# The legacy oracle, the fleet job mix, the data pipeline.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_decide_legacy_vmap_matches_jax(seed):
    js = make_cluster_state(max_jobs=32, total_nodes=32, n_queued=10,
                            n_running=3, seed=seed)
    ts = state_from_numpy(state_to_numpy(js), device="cpu")
    ids = [0, 1, 2, 3, 4, 5, 6]
    j = jwhatif.decide_legacy_vmap(js, jnp.asarray(ids, jnp.int32))
    t = whatif.decide_legacy_vmap(ts, whatif.pool_array(ids), device="cpu")
    assert int(t.policy_index) == int(j.policy_index)
    np.testing.assert_array_equal(_np(t.run_mask), np.asarray(j.run_mask))
    np.testing.assert_array_equal(_np(t.deadlocked),
                                  np.asarray(j.deadlocked))
    np.testing.assert_allclose(_np(t.costs), np.asarray(j.costs), rtol=RTOL)
    plain = des.simulate_to_drain(ts, torch.tensor(2))
    via = des.simulate_to_drain(ts, torch.tensor(2), REF.pass_fn())
    for x, y in zip(plain.state.jobs, via.state.jobs):
        assert torch.equal(x, y)               # the pass_fn path: same bits
    assert torch.equal(plain.first_started, via.first_started)
    d = REF.decide(ts, whatif.pool_array(ids))      # the engine agrees
    assert int(d.policy_index) == int(t.policy_index)
    assert torch.equal(d.run_mask, t.run_mask)
    # a PolicySpec stack rides the same loop
    spec = whatif.decide_legacy_vmap(ts, "paper", device="cpu")
    assert spec.costs.shape == (3,)


@pytest.mark.parametrize("seed", range(3))
def test_arch_job_mix_matches_jax(seed):
    t = twl.arch_job_mix(80, total_pods=32, seed=seed, mean_gap=25.0)
    j = jwl.arch_job_mix(80, total_pods=32, seed=seed, mean_gap=25.0)
    assert len(t) == len(j) == 80
    for a, b in zip(t, j):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert twl._ARCH_PODS == jwl._ARCH_PODS


def test_synthetic_lm_pipeline_matches_jax():
    cfg = dict(vocab_size=64, seq_len=12, global_batch=4, seed=3)
    t = tpipe.SyntheticLM(tpipe.DataConfig(**cfg)).batch(2)
    j = jpipe.SyntheticLM(jpipe.DataConfig(**cfg)).batch(2)
    for k in ("tokens", "labels", "mask"):
        np.testing.assert_array_equal(t[k], j[k])
    half = tpipe.host_slice(t, 1, 2)
    np.testing.assert_array_equal(half["tokens"], t["tokens"][2:])
    assert tpipe.host_slice(t)["tokens"] is not None   # (0, 1): identity
    np.testing.assert_array_equal(tpipe.host_slice(t)["tokens"],
                                  t["tokens"])
    with pytest.raises(ValueError, match="split"):
        tpipe.host_slice(t, 0, 3)


@pytest.mark.parametrize("S", [1, 3])
def test_assembled_replay_inputs_are_contiguous(scen5, S):
    """K1 takes contiguous rows: a one-scenario piece (a shard's share of
    a small block) must not hand it a broadcast view."""
    from repro_torch.core.engine import (_assemble_replay_inputs,
                                         scenario_arrays)
    rows = twl.slice_scenarios(scen5, 0, S)
    states, arrival_t, true_rt, pool, valid = _assemble_replay_inputs(
        *scenario_arrays(rows, torch.device("cpu")),
        parse_pool("paper").spec, 3)
    for t in (*states.jobs, states.free_nodes, states.total_nodes,
              states.now, arrival_t, true_rt, valid, *pool):
        assert t.is_contiguous() and t.shape[0] == 3 * S


def test_replay_loop_reads_stay_per_block(scen5, monkeypatch):
    """The stream adds no read of its own: every block's replay reads its
    condition once per ``des.REPLAY_BLOCK`` steps, as the one-shot
    replay does, and nothing else reads per block."""
    calls = []
    real = des.replay_cond
    monkeypatch.setattr(des, "replay_cond",
                        lambda c, a: (calls.append(1), real(c, a))[1])
    out = whatif.sharded_replay_grid(MESH[1], engine=REF, block_size=2)(
        scen5, parse_pool("paper"))
    assert 3 <= len(calls) <= int(out.result.iters)
