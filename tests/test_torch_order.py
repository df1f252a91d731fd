"""The engine's one plain order stage (``engine.OrderStage`` running the
``reference`` backend's order entry, ``kernels.priority_order``'s plain
version) against the order's definition, fork by fork, on the CPU.

The plain version is the stage of the ``reference`` backend, the branch
the kernel's wrapper takes for CPU tensors and what the kernel is held
to on the card (``tests/test_torch_cuda.py``): one call, in fork order,
for re-sorted and hoisted forks alike.  The definition takes one fork at
a time: a re-sorted fork's order is ``backfill.priority_order`` on the
pool as given (integer ids through the id stack), a hoisted fork's its
``static_priority_order`` compacted queued-first.  Every case compares
the (k, J) orders element for element over pools (the paper's, the
Polaris sweep, ``extended``, integer ids, ``expf:tau=600``, random θ
with nonzero ``wait``/``xfactor`` weights), J of 8, 150, 256 and 1,024,
no slots / some / all queued, hoist plans None, partial and all-static,
and rows planted with -0.0/+0.0 ties, ±inf and NaN keys.  Integer-id
pools lifted to their ``static_spec`` rows give the id stack's keys;
the drain and the replay call the backend's order entry once a step.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core import policies, telemetry
from repro_torch.core.backfill import (compact_queued_first, priority_order,
                                       static_priority_order)
from repro_torch.core.engine import DrainEngine, tile_pool
from repro_torch.core.policies import PolicySpec, parse_pool
from repro_torch.core.state import QUEUED, JobTable, SimState, map_state
from repro_torch.kernels import priority_order as po

from torch_threads import one_thread  # noqa: F401

REF = DrainEngine("reference", device="cpu")


def _random_pool(seed: int) -> PolicySpec:
    """Random θ rows of every family, nonzero ``wait`` and ``xfactor``
    weights (so no fork is time-invariant), exponents off {1, 2, 3}."""
    rng = np.random.default_rng(seed)
    k = 6
    theta = rng.normal(size=(k, policies.N_THETA)).astype(np.float32)
    theta[:, policies.TH_A] = rng.uniform(0.5, 4.5, size=k)
    theta[:, policies.TH_B] = rng.uniform(0.2, 2.0, size=k)
    theta[:, policies.TH_TAU] = rng.uniform(300.0, 7200.0, size=k)
    theta[0, policies.TH_TAU] = np.inf
    family = np.array([0, 1, 2, 1, 2, 0], dtype=np.int32)
    return PolicySpec(torch.from_numpy(family), torch.from_numpy(theta))


POOLS = {
    "paper": lambda: parse_pool("paper").spec,
    "polaris": lambda: parse_pool(
        "extended,wfp:a=1..5x5:tau=600..7200x5").spec,
    "extended": lambda: parse_pool("extended").spec,
    "ids": lambda: torch.tensor(policies.EXTENDED_POOL, dtype=torch.int32),
    "expf600": lambda: parse_pool("expf:tau=600").spec,
    "random_theta": lambda: _random_pool(7),
}


def _k(pool) -> int:
    return pool.family.shape[0] if isinstance(pool, PolicySpec) \
        else pool.shape[0]


def _states(k: int, J: int, queued: str, seed: int) -> SimState:
    """k forks of J slots: every lifecycle state, ``queued`` slots
    QUEUED ("none", "some" or "all"), submits around each fork's clock
    (some in its future), estimates below the 1 s floor, repeated keys."""
    rng = np.random.default_rng(seed)
    if queued == "all":
        state = np.full((k, J), QUEUED, dtype=np.int32)
    else:
        p = [0.2, 0.0, 0.4, 0.4] if queued == "none" else [0.1, 0.5, 0.2,
                                                          0.2]
        state = rng.choice(4, size=(k, J), p=p).astype(np.int32)
    now = rng.uniform(0.0, 2e4, size=k).astype(np.float32)
    submit = (now[:, None] - rng.choice([-600.0, 0.0, 600.0, 1800.0, 4e3],
                                        size=(k, J))
              - rng.uniform(0, 50, size=(k, J)).round()).astype(np.float32)
    est = rng.choice([0.5, 300.0, 3600.0, 7200.0], size=(k, J)).astype(
        np.float32)
    nodes = rng.integers(1, 64, size=(k, J)).astype(np.int32)
    t = torch.from_numpy
    jobs = JobTable(submit_t=t(submit), nodes=t(nodes), est_runtime=t(est),
                    start_t=t(submit), end_t=t(submit + est),
                    state=t(state))
    free = torch.full((k,), 100, dtype=torch.int32)
    return SimState(jobs=jobs, free_nodes=free, total_nodes=free.clone(),
                    now=t(now))


def _plan(pool, which: str, k: int):
    if which == "none":
        return None
    if which == "all":
        return (True,) * k
    mask = policies.time_invariant_mask(pool)
    if mask.any() and not mask.all():
        return tuple(bool(b) for b in mask)
    return tuple(i % 2 == 0 for i in range(k))


def _fork(x, f):
    return map_state(lambda leaf: leaf[f:f + 1], x) if isinstance(
        x, SimState) else x[f:f + 1]


def _fork_pool(pool, f):
    if isinstance(pool, PolicySpec):
        return PolicySpec(pool.family[f:f + 1], pool.theta[f:f + 1])
    return pool[f:f + 1]


def _defined_order(s0, st, pool, hoist, ever):
    """The (k, J) order by definition, one fork at a time: a hoisted
    fork's static order (ranked on ``s0`` over ``ever``) with its queued
    slots first, a re-sorted fork's ``backfill.priority_order``."""
    rows = []
    for f in range(st.jobs.state.shape[0]):
        one, p = _fork(st, f), _fork_pool(pool, f)
        if hoist is not None and hoist[f]:
            static = static_priority_order(_fork(s0, f), p, _fork(ever, f))
            rows.append(compact_queued_first(static,
                                             one.jobs.state == QUEUED))
        else:
            rows.append(priority_order(one, p))
    return torch.cat(rows)


@pytest.mark.parametrize("plan", ["none", "partial", "all"])
@pytest.mark.parametrize("queued", ["none", "some", "all"])
@pytest.mark.parametrize("J", [8, 150, 256, 1024])
@pytest.mark.parametrize("pool_name", sorted(POOLS))
def test_plain_version_matches_the_order_stage(pool_name, J, queued, plan):
    pool = tile_pool(POOLS[pool_name](), 2)
    k = _k(pool)
    s0 = _states(k, J, "some", seed=J)
    ever = (s0.jobs.state == QUEUED) | (torch.arange(J) % 3 == 0)
    hoist = _plan(pool, plan, k)
    stage = REF.order_fn(s0, pool, hoist, ever)
    for step in range(2):
        st = _states(k, J, queued, seed=100 * J + step)
        want = _defined_order(s0, st, pool, hoist, ever)
        got = stage(st)
        assert got.dtype == torch.int32 and got.shape == (k, J)
        assert torch.equal(got, want), (pool_name, J, queued, plan, step)


def _planted(J: int):
    """Forks whose keys tie at -0.0/+0.0, run to ±inf or turn NaN among
    finite keys, with slots that are not queued (key +inf) between."""
    th = np.zeros((5, policies.N_THETA), dtype=np.float32)
    fam = np.array([policies.FAM_WFP, 0, 0, 0, policies.FAM_WFP],
                   dtype=np.int32)
    th[0, :policies.N_FEATURES] = -0.0          # wfp: keys of ±0
    th[0, policies.TH_A], th[0, policies.TH_B] = 3.0, 1.0
    th[0, policies.TH_TAU] = np.inf
    th[1, policies.FEATURES.index("est")] = np.inf        # +inf when queued
    th[2, policies.FEATURES.index("est")] = -np.inf       # -inf
    th[3, policies.FEATURES.index("wait")] = np.inf       # NaN at wait 0
    th[4, policies.TH_A], th[4, policies.TH_B] = 2.5, 0.5
    th[4, policies.TH_TAU] = 900.0
    th[4, policies.FEATURES.index("submit")] = -0.0
    pool = PolicySpec(torch.from_numpy(fam), torch.from_numpy(th))
    k = 5
    rng = np.random.default_rng(J)
    slots = np.arange(J)[None, :].repeat(k, 0)
    state = np.where(slots % 7 == 6, 2, QUEUED).astype(np.int32)
    submit = np.array([0.0, -0.0, 600.0, -600.0, -1200.0, 0.0],
                      dtype=np.float32)[(slots + rng.integers(0, 6, (k, 1)))
                                        % 6]
    est = rng.choice([0.5, 1.0, 3600.0], size=(k, J)).astype(np.float32)
    nodes = rng.integers(1, 4, size=(k, J)).astype(np.int32)
    t = torch.from_numpy
    jobs = JobTable(submit_t=t(submit), nodes=t(nodes), est_runtime=t(est),
                    start_t=t(submit), end_t=t(submit), state=t(state))
    free = torch.full((k,), 8, dtype=torch.int32)
    return pool, SimState(jobs=jobs, free_nodes=free,
                          total_nodes=free.clone(),
                          now=torch.zeros(k, dtype=torch.float32))


@pytest.mark.parametrize("J", [8, 150, 256, 1024])
def test_plain_version_orders_planted_keys(J):
    pool, st = _planted(J)
    keys = po.priority_keys(st.jobs.state, st.jobs.submit_t,
                            st.jobs.est_runtime, st.jobs.nodes, st.now,
                            *po.pool_rows(pool, st.now.device))
    signs = torch.signbit(keys[0][keys[0] == 0])
    assert signs.any() and (~signs).any()            # -0.0 and +0.0
    assert (keys[1] == torch.inf).any() and (keys[2] == -torch.inf).any()
    assert keys[3].isnan().any() and (keys[3] == torch.inf).any()
    ever = st.jobs.state == QUEUED
    for hoist in (None, (False, True, False, True, False)):
        want = _defined_order(st, st, pool, hoist, ever)
        got = REF.order_fn(st, pool, hoist, ever)(st)
        assert torch.equal(got, want)


def test_integer_ids_lifted_give_the_id_stack_keys():
    """``pool_rows`` lifts integer ids to their ``static_spec`` rows (the
    EXPF row under ``FAM_EXPF_ID``): the keys equal
    ``policies.priority_key``'s wherever a slot is queued."""
    ids = torch.tensor(policies.EXTENDED_POOL * 3, dtype=torch.int32)
    st = _states(ids.shape[0], 150, "some", seed=3)
    family, theta = po.pool_rows(ids, st.now.device)
    assert family.dtype == torch.int32 and theta.shape == (21, 9)
    assert int(family[policies.EXPF]) == po.FAM_EXPF_ID
    got = po.priority_keys(st.jobs.state, st.jobs.submit_t,
                           st.jobs.est_runtime, st.jobs.nodes, st.now,
                           family, theta)
    want = torch.where(st.jobs.state == QUEUED,
                       policies.priority_key(st.jobs, st.now, ids.long()),
                       torch.inf)
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_loops_count_the_kernel_steps(backend, monkeypatch):
    """The drain and the replay call the backend's order entry once a
    step: as many calls as ``drain.steps`` and ``replay.steps`` (on the
    CPU the ``cuda`` entry takes its plain version)."""
    from repro_torch.cluster import workload
    calls = []
    entries = engine_mod.BACKENDS[backend]

    def order(*args):
        calls.append(1)
        return entries.order(*args)
    monkeypatch.setitem(engine_mod.BACKENDS, backend,
                        entries._replace(order=order))
    engine = DrainEngine(backend, device="cpu")
    pool = parse_pool("extended").spec
    snapshot = map_state(lambda x: x[0], _states(7, 64, "some", seed=5))
    scen = workload.stack_scenarios(
        [workload.bursty_trace(12, 16, 4.0, (1, 12), (30.0, 400.0), seed=1)],
        16, max_jobs=16)
    spans = telemetry.SPANS
    engine.drain(snapshot, pool)
    n = spans.roots[-1].counts()
    assert n["drain.steps"] > 0 and len(calls) == n["drain.steps"]
    calls.clear()
    engine.replay_grid(scen, pool)
    n = spans.roots[-1].counts()
    assert n["replay.steps"] > 0 and len(calls) == n["replay.steps"]
