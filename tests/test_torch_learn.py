"""The port's policy learner (``repro_torch.learn``) against the JAX
package's ``repro.learn``, on the CPU.

Corpus: ``tests/test_learn.py``'s split (3 training and 2 held-out
16-job Poisson traces on 16 nodes, ``default_rng(3)``), the port's
``reference`` engine on the CPU and the JAX package's ``reference``
engine.

* ``draw_eps``: bitwise ``jax.random``'s (a hypothesis test over seed,
  generation, population 1-33, dimension 1-9 and antithetic pairing).
* ES and CEM ``ask``/``tell``, ``rank_fitness``,
  ``centered_rank_utilities``: bitwise on the same state and fitness.
* ``family_space`` (boxes, ``x0``, ``sigma0``, ``clip``, ``decode``) and
  ``static_seeds``: bitwise.
* The ports of ``tests/test_learn.py``: generation costs bitwise the
  per-θ serial grids (with and without a fan), strategy determinism,
  antithetic prefix-stable draws, non-finite fitness ranked worst,
  ``train`` determinism, checkpoint resume bitwise, held-out early stop,
  the warm start's floor, ``trained:`` deploy parity and its errors.
* ``train`` against the JAX trainer for lin, wfp and expf × cem and es ×
  ``avg_wait`` and ``score``: θ bitwise; history names, ``improved``
  flags and generation counts equal; costs within rtol 1e-5 (f32 metric
  sums in torch's order, ROADMAP C4).  No input of this corpus parts
  them by a rank tie.
* Across packages: a JAX trainer checkpoint at generation 2 resumed by
  the port ends as the JAX uninterrupted run does, and the port resumed
  by JAX likewise; ``trained:<JAX dir>`` gives the port the same θ and
  name.
"""
import dataclasses

import numpy as np
import pytest

from repro.cluster.workload import poisson_trace as jpoisson
from repro.cluster.workload import split_scenarios as jsplit
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import parse_pool as jparse
from repro.learn import CEM as JCEM
from repro.learn import ES as JES
from repro.learn import TrainConfig as JConfig
from repro.learn import family_space as jspace
from repro.learn import static_seeds as jseeds
from repro.learn import train as jtrain
from repro.learn.strategy import centered_rank_utilities as jutil
from repro.learn.strategy import draw_eps as jdraw
from repro.learn.strategy import rank_fitness as jrank
from repro_torch.cluster.workload import poisson_trace, split_scenarios
from repro_torch.core.engine import DrainEngine
from repro_torch.core.fan import FanSpec
from repro_torch.core.policies import (FAM_EXP, FAM_LIN, FAM_WFP,
                                       parse_pool, theta_pool)
from repro_torch.learn import (CEM, ES, TrainConfig, family_space,
                               load_trained_pool, static_seeds, train)
from repro_torch.learn.strategy import (centered_rank_utilities, draw_eps,
                                        rank_fitness)

REF = DrainEngine("reference", device="cpu")
JREF = JEngine("reference")
RTOL = 1e-5

TRACE = lambda r: poisson_trace(16, 16, 45.0, (1, 6), (60.0, 900.0),  # noqa
                                rng=r)
JTRACE = lambda r: jpoisson(16, 16, 45.0, (1, 6), (60.0, 900.0),  # noqa
                            rng=r)


@pytest.fixture(scope="module")
def split():
    return split_scenarios(np.random.default_rng(3), TRACE, 3, 2, 16)


@pytest.fixture(scope="module")
def jsplit_():
    return jsplit(np.random.default_rng(3), JTRACE, 3, 2, 16)


def tiny_config(cls=TrainConfig, **kw):
    base = dict(family="lin", strategy="cem", population=6, generations=3,
                objective="avg_wait", seed=5, patience=0)
    base.update(kw)
    return cls(**base)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


# ----------------------------------------------------------------------
# draws, strategies and search spaces: bitwise the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,gen,pop,dim,anti", [
    (0, 0, 16, 9, True), (5, 3, 7, 3, True), (2**31 + 1, 17, 33, 1, False),
    (42, 0, 1, 6, True), (7, 1000, 2, 9, False)])
def test_draw_eps_matches_jax(seed, gen, pop, dim, anti):
    got = draw_eps(seed, gen, pop, dim, anti)
    want = jdraw(seed, gen, pop, dim, anti)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hypothesis_draw_eps_matches_jax():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1), gen=st.integers(0, 10_000),
           pop=st.integers(1, 33), dim=st.integers(1, 9),
           anti=st.booleans())
    def run(seed, gen, pop, dim, anti):
        np.testing.assert_array_equal(
            draw_eps(seed, gen, pop, dim, anti).view(np.uint32),
            jdraw(seed, gen, pop, dim, anti).view(np.uint32))

    run()


FITNESS = [np.asarray([3.0, 1.0, np.inf, 2.0, 5.0, 0.5]),
           np.asarray([1.0, 1.0, np.nan, 1.0, 2.0, -np.inf]),
           np.random.default_rng(0).standard_normal(6)]


@pytest.mark.parametrize("fit", range(len(FITNESS)))
@pytest.mark.parametrize("kind", ["es", "cem"])
@pytest.mark.parametrize("family", ["lin", "wfp", "expf"])
def test_ask_tell_bitwise(kind, family, fit):
    fitness = FITNESS[fit]
    space, jsp = family_space(family), jspace(family)
    port = (ES if kind == "es" else CEM)(population=6, seed=9)
    ref = (JES if kind == "es" else JCEM)(population=6, seed=9)
    st = port.init(np.asarray(space.x0), np.asarray(space.sigma0))
    jst = ref.init(np.asarray(jsp.x0), np.asarray(jsp.sigma0))
    for _ in range(2):
        z, jz = port.ask(st), ref.ask(jst)
        np.testing.assert_array_equal(z, jz)
        st, jst = port.tell(st, z, fitness), ref.tell(jst, jz, fitness)
        np.testing.assert_array_equal(st.mean, jst.mean)
        np.testing.assert_array_equal(st.sigma, jst.sigma)
        assert st.gen == jst.gen
    np.testing.assert_array_equal(rank_fitness(fitness), jrank(fitness))
    np.testing.assert_array_equal(centered_rank_utilities(fitness),
                                  jutil(fitness))


@pytest.mark.parametrize("family", ["lin", "wfp", "expf"])
def test_family_space_and_static_seeds_bitwise(family):
    a, b = family_space(family), jspace(family)
    for f in ("family", "names", "idx", "lo", "hi", "log10", "x0",
              "sigma0"):
        assert getattr(a, f) == getattr(b, f), f
    z = np.random.default_rng(1).uniform(-10, 10, (50, a.dim))
    np.testing.assert_array_equal(a.clip(z), b.clip(z))
    np.testing.assert_array_equal(a.decode(z), b.decode(z))
    fam = a.family
    mine, theirs = static_seeds(fam), jseeds(fam)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (_, x), (_, y) in zip(mine, theirs):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# ports of tests/test_learn.py
# ----------------------------------------------------------------------

def test_generation_costs_bitwise_serial(split):
    train_scen, _ = split
    space = family_space("lin")
    thetas = space.decode(draw_eps(0, 0, 5, space.dim, True))
    pool = theta_pool(FAM_LIN, thetas)
    batched = _np(REF.generation_costs(train_scen, pool.spec, "avg_wait"))
    serial = np.stack([
        _np(REF.replay_grid(train_scen,
                            theta_pool(FAM_LIN, thetas[i:i + 1]).spec,
                            "avg_wait").costs)[:, 0]
        for i in range(len(thetas))], axis=1)
    assert np.array_equal(batched, serial)


def test_generation_costs_fan_bitwise_serial(split):
    train_scen, _ = split
    fan = FanSpec(n=3, runtime_noise=0.3, seed=2)
    thetas = family_space("wfp").decode(draw_eps(1, 0, 4, 3, True))
    pool = theta_pool(FAM_WFP, thetas)
    batched = _np(REF.generation_costs(train_scen, pool.spec, "avg_wait",
                                       fan))
    serial = np.stack([
        _np(REF.fan_grid(train_scen,
                         theta_pool(FAM_WFP, thetas[i:i + 1]).spec, fan,
                         "avg_wait").costs)[:, 0]
        for i in range(len(thetas))], axis=1)
    assert np.array_equal(batched, serial)


@pytest.mark.parametrize("strat_cls", [ES, CEM], ids=["es", "cem"])
def test_strategy_step_deterministic(strat_cls):
    space = family_space("wfp")
    fit = np.asarray([3.0, 1.0, np.inf, 2.0, 5.0, 0.5], np.float64)
    states = []
    for _ in range(2):
        s = strat_cls(population=6, seed=9)
        st = s.init(np.asarray(space.x0), np.asarray(space.sigma0))
        z = s.ask(st)
        states.append((z, s.tell(st, z, fit)))
    (z_a, st_a), (z_b, st_b) = states
    assert np.array_equal(z_a, z_b)
    assert np.array_equal(st_a.mean, st_b.mean)
    assert np.array_equal(st_a.sigma, st_b.sigma)
    assert st_a.gen == st_b.gen == 1


def test_draws_antithetic_and_prefix_stable():
    small = draw_eps(seed=4, gen=2, population=6, dim=5, antithetic=True)
    big = draw_eps(seed=4, gen=2, population=10, dim=5, antithetic=True)
    assert np.array_equal(small, big[:6])
    assert np.array_equal(small[0::2], -small[1::2])
    assert np.array_equal(small, draw_eps(4, 2, 6, 5, True))
    assert not np.array_equal(small, draw_eps(4, 3, 6, 5, True))


def test_rank_utilities_nonfinite_worst():
    u = centered_rank_utilities(np.asarray([2.0, np.inf, 1.0, np.nan]))
    assert u[2] == 0.5
    assert {u[1], u[3]} == {min(u), sorted(u)[1]}
    assert abs(float(u.sum())) < 1e-6


@pytest.mark.parametrize("strategy", ["cem", "es"])
def test_train_deterministic(split, strategy):
    train_scen, heldout = split
    runs = [train(train_scen, heldout, tiny_config(strategy=strategy),
                  engine=REF) for _ in range(2)]
    assert np.array_equal(runs[0].theta, runs[1].theta)
    assert runs[0].history == runs[1].history
    assert runs[0].best_heldout == runs[1].best_heldout


def test_checkpoint_resume_bitwise(split, tmp_path):
    train_scen, heldout = split
    cfg = tiny_config(generations=4)
    full = train(train_scen, heldout, cfg, engine=REF,
                 checkpoint_dir=str(tmp_path / "full"))
    part_dir = str(tmp_path / "part")
    train(train_scen, heldout, dataclasses.replace(cfg, generations=2),
          engine=REF, checkpoint_dir=part_dir)
    resumed = train(train_scen, heldout, cfg, engine=REF,
                    checkpoint_dir=part_dir, resume=True)
    assert np.array_equal(full.theta, resumed.theta)
    assert full.history == resumed.history
    assert full.best_heldout == resumed.best_heldout
    a = load_trained_pool(str(tmp_path / "full"))
    b = load_trained_pool(part_dir)
    assert np.array_equal(_np(a.spec.theta), _np(b.spec.theta))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train(train_scen, heldout, cfg, engine=REF, resume=True)


def test_heldout_early_stop_triggers(split):
    train_scen, heldout = split
    cfg = tiny_config(strategy="es", generations=10, patience=2,
                      sigma_scale=0.0)
    res = train(train_scen, heldout, cfg, engine=REF)
    assert res.stopped_early
    assert res.generations_run == 3
    assert all(not r["improved"] for r in res.history[1:])


def test_warm_start_floors_at_best_static(split):
    train_scen, heldout = split
    res = train(train_scen, heldout,
                tiny_config(generations=1, sigma_scale=0.0), engine=REF)
    names, thetas = zip(*static_seeds(FAM_LIN))
    costs = REF.replay_grid(
        heldout, theta_pool(FAM_LIN, np.stack(thetas), names).spec,
        "avg_wait").costs
    agg = np.asarray(_np(costs), np.float64).mean(axis=0)
    assert res.best_heldout <= float(agg.min())


def test_trained_grammar_deploy_parity(split, tmp_path):
    train_scen, heldout = split
    ckpt = str(tmp_path / "ck")
    res = train(train_scen, heldout, tiny_config(), engine=REF,
                checkpoint_dir=ckpt)
    pool = parse_pool(f"trained:{ckpt},paper")
    assert pool.names[0] == "trained[lin]"
    assert len(pool) == 4
    assert np.array_equal(_np(pool.spec.theta[0]), res.theta)
    via_ckpt = _np(REF.replay_grid(heldout, pool.spec,
                                   "avg_wait").costs)[:, 0]
    in_mem = _np(REF.replay_grid(heldout, res.pool.spec,
                                 "avg_wait").costs)[:, 0]
    assert np.array_equal(via_ckpt, in_mem)


def test_trained_grammar_errors(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        parse_pool("trained:")
    with pytest.raises(FileNotFoundError):
        parse_pool(f"trained:{tmp_path}/nope")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no valid checkpoint"):
        parse_pool(f"trained:{empty}")


# ----------------------------------------------------------------------
# train() against the JAX trainer
# ----------------------------------------------------------------------

def _assert_same_run(port, ref, ctx=""):
    np.testing.assert_array_equal(port.theta, ref.theta, err_msg=ctx)
    assert port.generations_run == ref.generations_run, ctx
    assert port.stopped_early == ref.stopped_early, ctx
    assert (port.family, port.label, port.best_desc) == (
        ref.family, ref.label, ref.best_desc), ctx
    assert len(port.history) == len(ref.history), ctx
    for a, b in zip(port.history, ref.history):
        assert list(a) == list(b), ctx
        for k in ("gen", "incumbent", "improved"):
            assert a[k] == b[k], (ctx, k, a[k], b[k])
        floats = [k for k in a if isinstance(b[k], float)]
        np.testing.assert_allclose([a[k] for k in floats],
                                   [b[k] for k in floats], rtol=RTOL,
                                   err_msg=ctx)
    np.testing.assert_allclose([port.best_heldout, port.best_train],
                               [ref.best_heldout, ref.best_train],
                               rtol=RTOL, err_msg=ctx)


@pytest.mark.parametrize("objective", ["avg_wait", "score"])
@pytest.mark.parametrize("strategy", ["cem", "es"])
@pytest.mark.parametrize("family", ["lin", "wfp", "expf"])
def test_train_matches_jax_trainer(split, jsplit_, family, strategy,
                                   objective):
    kw = dict(family=family, strategy=strategy, objective=objective,
              generations=2)
    port = train(*split, tiny_config(**kw), engine=REF)
    ref = jtrain(*jsplit_, tiny_config(JConfig, **kw), engine=JREF)
    _assert_same_run(port, ref, str(kw))


def test_a_jax_trainer_checkpoint_resumes_in_the_port(split, jsplit_,
                                                      tmp_path):
    cfg = dict(family="wfp", generations=4)
    full = jtrain(*jsplit_, tiny_config(JConfig, **cfg), engine=JREF)
    ckpt = str(tmp_path / "jax")
    jtrain(*jsplit_, tiny_config(JConfig, **dict(cfg, generations=2)),
           engine=JREF, checkpoint_dir=ckpt)
    resumed = train(*split, tiny_config(**cfg), engine=REF,
                    checkpoint_dir=ckpt, resume=True)
    _assert_same_run(resumed, full)
    # and the port's pool grammar deploys the JAX run's θ
    pool, jpool = parse_pool(f"trained:{ckpt}"), jparse(f"trained:{ckpt}")
    assert pool.names == jpool.names == ("trained[wfp]",)
    np.testing.assert_array_equal(_np(pool.spec.theta),
                                  np.asarray(jpool.spec.theta))
    assert int(pool.spec.family[0]) == int(jpool.spec.family[0]) == FAM_WFP


def test_a_port_trainer_checkpoint_resumes_in_jax(split, jsplit_, tmp_path):
    cfg = dict(family="expf", strategy="es", generations=4)
    full = train(*split, tiny_config(**cfg), engine=REF)
    ckpt = str(tmp_path / "port")
    train(*split, tiny_config(**dict(cfg, generations=2)), engine=REF,
          checkpoint_dir=ckpt)
    resumed = jtrain(*jsplit_, tiny_config(JConfig, **cfg), engine=JREF,
                     checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, resumed)
    assert int(jparse(f"trained:{ckpt}").spec.family[0]) == FAM_EXP
