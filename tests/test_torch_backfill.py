"""The port's plain batched pass against ``repro.core.backfill``.

Tolerance: none.  Started sets and free-node counts are integers and
booleans, and the pass's float work is one f32 add (``now + est``) and
comparisons, identical in both packages; so every check is bitwise
(``assert_array_equal``).  The same job tables, made once with numpy,
go to ``jax.vmap(schedule_pass_with_order)`` and to the port.

The JAX Pallas kernel (interpret mode, as ``tests/test_kernels_policy_eval``
runs it on the CPU) is run on the forced end-time ties too: where it
parts from the reference (ROADMAP C1), the port is held to the
reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backfill as jbf
from repro.core import des as jdes
from repro.core import policies as jpol
from repro.core.state import QUEUED, RUNNING, SimState, JobTable
from repro.kernels import policy_eval as jpe
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import backfill as tbf
from repro_torch.core import policies as tpol

from conftest import make_cluster_state
from torch_threads import one_thread  # noqa: F401


N_SNAPSHOTS = 60
MAX_JOBS = 48

_vpass = jax.jit(jax.vmap(jbf.schedule_pass_with_order, in_axes=(0, 0, None)))
_vorder = jax.jit(jax.vmap(jbf.priority_order, in_axes=(None, 0)))
_vorder_b = jax.jit(jax.vmap(jbf.priority_order))
_limit = jax.jit(jdes.pass_rank_limit)


@functools.lru_cache(maxsize=None)
def _snapshot(seed):
    return make_cluster_state(max_jobs=MAX_JOBS, total_nodes=32, seed=seed,
                              n_queued=4 + seed % 24, n_running=seed % 6,
                              now=100.0 + 37.0 * seed)


def _batched(jstate, k):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (k,) + x.shape),
                        jstate)


def _port_pass(jstates, order, limit):
    st = state_from_numpy(state_to_numpy(jstates), device="cpu")
    lim = None if limit is None else torch.tensor(
        [int(limit)], dtype=torch.int32)
    return tbf.schedule_pass_batched(
        torch.from_numpy(np.array(order)), st.jobs.state, st.jobs.nodes,
        st.jobs.est_runtime, st.jobs.end_t, st.free_nodes, st.now, lim)


def _check(jstates, order, limit, ctx=""):
    ref = _vpass(jstates, order, limit)
    started, free = _port_pass(jstates, order, limit)
    np.testing.assert_array_equal(started.numpy(), np.asarray(ref.started),
                                  err_msg=ctx)
    np.testing.assert_array_equal(free.numpy(),
                                  np.asarray(ref.state.free_nodes),
                                  err_msg=ctx)
    assert free.dtype == torch.int32 and started.dtype == torch.bool
    return ref


#: The forks every batched check runs (k=9; one shape, one compile).
POOL = "extended,wfp:a=2:tau=600,expf:tau=600"
FCFS_ROW = 1


@pytest.mark.parametrize("bounded", [False, True],
                         ids=["limit_none", "limit_rank"])
def test_plain_pass_bitwise_on_snapshots(bounded):
    pool = jpol.parse_pool(POOL)
    k = len(pool)
    for seed in range(N_SNAPSHOTS):
        js = _snapshot(seed)
        order = _vorder(js, pool.spec)
        jstates = _batched(js, k)
        limit = None
        if bounded:
            limit = _limit(jstates, jnp.ones((k,), bool))
        _check(jstates, order, limit, ctx=f"seed {seed} bounded={bounded}")


def test_plain_pass_bitwise_mid_drain():
    """Diverged fork states: apply one reference pass per fork, advance
    the clock, and compare the second pass on the (k, J) rows."""
    pool = jpol.parse_pool("extended")
    for seed in range(0, N_SNAPSHOTS, 3):
        js = _snapshot(seed)
        jstates = _batched(js, len(pool))
        first = _vpass(jstates, _vorder(js, pool.spec), None).state
        t = jnp.asarray(150.0 + 41.0 * seed, jnp.float32)
        moved = first._replace(now=jnp.maximum(first.now, t))
        order = _vorder_b(moved, pool.spec)
        limit = _limit(moved, jnp.ones((len(pool),), bool))
        _check(moved, order, limit, ctx=f"seed {seed}")


def _hand_state(total, running, queued, now=0.0, J=MAX_JOBS):
    """running: (nodes, end_t) per slot; queued: (nodes, est) per slot,
    slots after the running ones, FCFS by slot."""
    submit = np.full(J, -1.0, np.float32)
    nodes = np.zeros(J, np.int32)
    est = np.zeros(J, np.float32)
    start = np.full(J, -1.0, np.float32)
    end = np.full(J, -1.0, np.float32)
    state = np.zeros(J, np.int32)
    used = 0
    for s, (n, e) in enumerate(running):
        submit[s], nodes[s], est[s] = 0.0, n, e
        start[s], end[s], state[s] = 0.0, e, RUNNING
        used += n
    for i, (n, e) in enumerate(queued):
        s = len(running) + i
        submit[s], nodes[s], est[s], state[s] = float(s), n, e, QUEUED
    return SimState(
        jobs=JobTable(*(jnp.asarray(a) for a in
                        (submit, nodes, est, start, end, state))),
        free_nodes=jnp.int32(total - used), total_nodes=jnp.int32(total),
        now=jnp.float32(now))


#: The C1 case: two running jobs end together at t=100.  The head (5
#: nodes) needs free1=2 plus the FIRST of them (lex order), so the
#: reference's extra is 1; the Pallas kernel's inclusive count takes
#: both (free_at=10, extra=5) and lets the 2-node, 1000 s job backfill.
C1_STATE = dict(total=10, running=[(4, 100.0), (4, 100.0)],
                queued=[(5, 50.0), (2, 1000.0)])

TIE_STATES = {
    "c1_two_ties": C1_STATE,
    "three_way_tie": dict(total=12, running=[(3, 50.0), (3, 50.0), (3, 50.0)],
                          queued=[(7, 10.0), (2, 500.0), (1, 20.0), (2, 60.0)]),
    "tie_with_started": dict(total=8, running=[(4, 200.0)],
                             queued=[(2, 200.0), (4, 30.0), (1, 900.0),
                                     (1, 150.0)]),
    "tie_at_shadow_cond_a": dict(total=9, running=[(3, 80.0), (3, 80.0),
                                                   (2, 120.0)],
                                 queued=[(4, 5.0), (1, 80.0), (1, 81.0),
                                         (1, 400.0)]),
    "no_head": dict(total=16, running=[(4, 10.0)],
                    queued=[(2, 5.0), (3, 5.0), (1, 5.0)]),
    "empty_queue": dict(total=8, running=[(4, 10.0), (2, 10.0)], queued=[]),
    "larger_than_cluster": dict(total=8, running=[(2, 10.0)],
                                queued=[(9, 5.0), (1, 5.0), (6, 500.0)]),
    "nothing_running": dict(total=4, running=[], queued=[(5, 5.0), (4, 1.0),
                                                          (1, 1.0)]),
}


def _pallas(jstates, order):
    jobs = jstates.jobs
    running = jobs.state == RUNNING
    started, free = jpe.policy_eval_pass_batched(
        order, jobs.state == QUEUED, jobs.nodes, jobs.est_runtime,
        jnp.where(running, jobs.end_t, jnp.inf),
        jnp.where(running, jobs.nodes, 0), jstates.free_nodes,
        jstates.now, None, interpret=True)
    return np.asarray(started) > 0, np.asarray(free)


@pytest.mark.parametrize("name", sorted(TIE_STATES))
def test_forced_ties_and_edge_cases(name):
    js = _hand_state(**TIE_STATES[name])
    pool = jpol.parse_pool(POOL)
    order = _vorder(js, pool.spec)
    jstates = _batched(js, len(pool))
    ref = _check(jstates, order, None, ctx=name)
    # the scalar form and its head/shadow agree too
    ts = state_from_numpy(state_to_numpy(js), device="cpu")
    for row in range(len(pool)):
        tp = tbf.schedule_pass_with_order(
            ts, torch.from_numpy(np.array(order[row])))
        np.testing.assert_array_equal(tp.head_idx.numpy(),
                                      np.asarray(ref.head_idx[row]))
        np.testing.assert_array_equal(tp.shadow_time.numpy(),
                                      np.asarray(ref.shadow_time[row]))


def test_c1_pallas_inclusive_tie_rule_departs_from_reference():
    """ROADMAP C1, on record: on the C1 state the Pallas kernel starts
    the 2-node job (slot 3) under FCFS that the reference holds back;
    the port follows the reference.  On the other tie states the kernel
    and the reference agree."""
    pool = jpol.parse_pool(POOL)
    for name in sorted(TIE_STATES):
        hs = _hand_state(**TIE_STATES[name])
        order = _vorder(hs, pool.spec)
        jstates = _batched(hs, len(pool))
        ref = _check(jstates, order, None, ctx=name)
        pal_started, pal_free = _pallas(jstates, order)
        if name != "c1_two_ties":
            np.testing.assert_array_equal(pal_started,
                                          np.asarray(ref.started),
                                          err_msg=name)
            continue
        assert not bool(ref.started[FCFS_ROW, 3])
        assert int(ref.state.free_nodes[FCFS_ROW]) == 2
        assert pal_started[FCFS_ROW, 3] and pal_free[FCFS_ROW] == 0.0


_jpass = jax.jit(jbf.schedule_pass)


def test_scalar_pass_on_port_orders():
    """The unbatched pass end to end (port keys, port argsort, port
    pass) against ``backfill.schedule_pass``."""
    for seed in range(0, N_SNAPSHOTS, 5):
        js = _snapshot(seed)
        ts = state_from_numpy(state_to_numpy(js), device="cpu")
        for pid in jpol.EXTENDED_POOL:
            jres = _jpass(js, jpol.static_spec(pid))
            tres = tbf.schedule_pass(ts, tpol.static_spec(pid))
            for name in ("started", "head_idx", "shadow_time"):
                np.testing.assert_array_equal(
                    getattr(tres, name).numpy(),
                    np.asarray(getattr(jres, name)),
                    err_msg=f"seed {seed} policy {pid} {name}")
            for name, a, b in zip(SimState._fields[1:], tres.state[1:],
                                  jres.state[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)
            for name, a, b in zip(JobTable._fields, tres.state.jobs,
                                  jres.state.jobs):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)
