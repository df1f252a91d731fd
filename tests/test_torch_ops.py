"""K1', the scheduling pass on one shared snapshot
(``repro_torch.kernels.ops.twin_schedule_pass`` ->
``kernels.policy_eval.policy_eval_pass``), against the JAX package's.

Tolerance: none.  Started sets and free-node counts are integers, so
every check is bitwise.  The same snapshots (``conftest.make_cluster_state``
and the hand-built tie states of ``tests/test_torch_backfill.py``) go to
both packages.

* Against the reference pass, ``ref.policy_eval_ref`` (one
  ``core.schedule_pass`` per policy): every snapshot of the corpus, the
  paper and extended pools, and every forced-tie state.
* Against the Pallas entry, ``ops.twin_schedule_pass`` in interpret mode,
  on the corpus, whose running and just-started jobs never end together
  (checked), so the shadow-time tie rule does not come into play.
* C1 (ROADMAP): on ``C1_STATE`` the Pallas kernel backfills the 2-node
  job (slot 3) under every policy and the reference does not; the port
  follows the reference, and that slot is the whole difference.
* On CPU tensors the wrapper is its plain version, the batched pass on
  the shared rows expanded to k, and launches nothing; a ``PolicySpec``
  pool gives the orders of ``core.backfill.priority_order``.
* K1' itself on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import EXTENDED_POOL, PAPER_POOL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import backfill as tbf
from repro_torch.core import des as tdes
from repro_torch.core.policies import parse_pool
from repro_torch.core.state import QUEUED, RUNNING
from repro_torch.kernels import ops
from repro_torch.kernels import policy_eval as pe

from conftest import make_cluster_state
from test_torch_backfill import C1_STATE, TIE_STATES, _hand_state
from torch_threads import one_thread  # noqa: F401


POOLS = {"paper": PAPER_POOL, "extended": EXTENDED_POOL}
CORPUS = [dict(max_jobs=32 + 16 * (seed % 3), seed=seed,
               n_queued=seed % 21, n_running=seed % 7)
          for seed in range(24)]


def _port(jstate, pool):
    st = state_from_numpy(state_to_numpy(jstate), device="cpu")
    launches = pe.SHARED_LAUNCHES
    started, free = ops.twin_schedule_pass(
        st, torch.tensor(pool, dtype=torch.int32))
    assert pe.SHARED_LAUNCHES == launches   # CPU tensors: the plain pass
    assert started.dtype == torch.bool and free.dtype == torch.int32
    return started.numpy(), free.numpy()


def _assert_same(got, want, ctx):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]) > 0,
                                  err_msg=ctx)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]), err_msg=ctx)


def _no_end_ties(jstate):
    """True when no two running or startable jobs can end together:
    running ends and ``now + est`` of queued jobs all distinct."""
    jobs = jstate.jobs
    st = np.asarray(jobs.state)
    ends = np.concatenate([
        np.asarray(jobs.end_t)[st == RUNNING],
        (np.float32(jstate.now) + np.asarray(jobs.est_runtime))[st == QUEUED]])
    return len(np.unique(ends)) == len(ends)


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("case", range(len(CORPUS)))
def test_shared_pass_matches_reference(case, pool):
    jstate = make_cluster_state(**CORPUS[case])
    jpool = jnp.asarray(POOLS[pool], dtype=jnp.int32)
    _assert_same(_port(jstate, POOLS[pool]),
                 jref.policy_eval_ref(jstate, jpool), f"case {case}")


@pytest.mark.parametrize("case", range(0, len(CORPUS), 3))
def test_shared_pass_matches_pallas_without_ties(case):
    jstate = make_cluster_state(**CORPUS[case])
    assert _no_end_ties(jstate)
    jpool = jnp.asarray(EXTENDED_POOL, dtype=jnp.int32)
    _assert_same(_port(jstate, EXTENDED_POOL),
                 jops.twin_schedule_pass(jstate, jpool, interpret=True),
                 f"case {case}")


@pytest.mark.parametrize("name", sorted(TIE_STATES))
def test_shared_pass_on_tie_states(name):
    jstate = _hand_state(**TIE_STATES[name])
    jpool = jnp.asarray(PAPER_POOL, dtype=jnp.int32)
    _assert_same(_port(jstate, PAPER_POOL),
                 jref.policy_eval_ref(jstate, jpool), name)


def test_c1_is_the_listed_difference_from_pallas():
    jstate = _hand_state(**C1_STATE)
    jpool = jnp.asarray(PAPER_POOL, dtype=jnp.int32)
    started, free = _port(jstate, PAPER_POOL)
    p_started, p_free = jops.twin_schedule_pass(jstate, jpool,
                                                interpret=True)
    p_started = np.asarray(p_started) > 0
    diff = np.argwhere(started != p_started)
    assert [tuple(d) for d in diff] == [(row, 3)
                                        for row in range(len(PAPER_POOL))]
    assert not started[:, 3].any() and p_started[:, 3].all()
    np.testing.assert_array_equal(np.asarray(p_free), free - 2)


def test_cpu_wrapper_is_the_expanded_batched_pass():
    jstate = make_cluster_state(max_jobs=48, seed=5, n_queued=17,
                                n_running=4)
    st = state_from_numpy(state_to_numpy(jstate), device="cpu")
    pool = parse_pool("extended,wfp:a=1..3x3:tau=600..7200x2").spec
    k = pool.family.shape[0]
    got = ops.twin_schedule_pass(st, pool)
    states = tdes.broadcast_state(st, k)
    order = tbf.priority_order(states, pool)
    np.testing.assert_array_equal(order.numpy(),
                                  tbf.priority_order(st, pool).numpy())
    jobs = states.jobs
    want = tbf.schedule_pass_batched(order, jobs.state, jobs.nodes,
                                     jobs.est_runtime, jobs.end_t,
                                     states.free_nodes, states.now)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    limit = torch.tensor([int((st.jobs.state == QUEUED).sum())],
                         dtype=torch.int32)
    got = pe.policy_eval_pass(order, st.jobs.state, st.jobs.nodes,
                              st.jobs.est_runtime, st.jobs.end_t,
                              st.free_nodes, st.now, limit)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
