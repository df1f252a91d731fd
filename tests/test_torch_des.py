"""The port's batched drain against ``repro.core.des`` / the JAX engine.

Corpus: ``tests/test_engine.py``'s 60 snapshots (J=48), drained by both
packages over the extended pool with the plain (``reference``) backend.

Tolerances:
  * ``first_started``, ``deadlocked``, per-fork ``iters`` and the final
    ``start_t``/``end_t``/``state``/``free_nodes``: bitwise.  The drain's
    float work is f32 adds of the same operands and comparisons;
  * ``state_metrics``: ``rtol=1e-5``.  Its f32 sums over J run in
    torch's order, not XLA's (ROADMAP C4); max/min terms are exact;
  * the port's batched drain against its own scalar ``simulate_to_drain``:
    bitwise, metrics included (same code, same order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import des as jdes
from repro.core.engine import DrainEngine as JEngine
from repro.core.policies import parse_pool as jparse
from repro.core.state import QUEUED
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import des as tdes
from repro_torch.core.engine import DrainEngine as TEngine
from repro_torch.core.policies import parse_pool as tparse
from repro_torch.core.state import map_state

from conftest import make_cluster_state
from torch_threads import one_thread  # noqa: F401


N_SNAPSHOTS = 60
MAX_JOBS = 48
POOL = "extended"

JREF = JEngine("reference")
TREF = TEngine("reference", device="cpu")
_jmetrics = jax.jit(jax.vmap(jdes.state_metrics, in_axes=(0, None)))


@functools.lru_cache(maxsize=None)
def _snapshots():
    # the corpus of tests/test_engine.py::_snapshots, made once
    return tuple(make_cluster_state(
        max_jobs=MAX_JOBS, total_nodes=32, seed=seed,
        n_queued=4 + seed % 16, n_running=seed % 5,
        now=100.0 + 37.0 * seed) for seed in range(N_SNAPSHOTS))


def _eq(a, b, msg):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def test_batched_drain_matches_reference_bitwise():
    jpool, tpool = jparse(POOL).spec, tparse(POOL).spec
    for i, js in enumerate(_snapshots()):
        ts = state_from_numpy(state_to_numpy(js), device="cpu")
        jr = JREF.drain(js, jpool)
        tr = TREF.drain(ts, tpool)
        ctx = f"snapshot {i}"
        _eq(tr.first_started.numpy(), jr.first_started, ctx)
        _eq(tr.deadlocked.numpy(), jr.deadlocked, ctx)
        _eq(tr.iters.numpy(), jr.iters, ctx)
        for name in ("start_t", "end_t", "state"):
            _eq(getattr(tr.state.jobs, name).numpy(),
                getattr(jr.state.jobs, name), f"{ctx} {name}")
        _eq(tr.state.free_nodes.numpy(), jr.state.free_nodes, ctx)
        _eq(tr.state.now.numpy(), jr.state.now, ctx)
        eval_mask = js.jobs.state == QUEUED
        jm = _jmetrics(jr.state, eval_mask)
        tm = tdes.state_metrics(tr.state, ts.jobs.state == QUEUED)
        for name, a, b in zip(tm._fields, tm, jm):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       err_msg=f"{ctx} {name}")


def test_batched_drain_equals_scalar_oracle_bitwise():
    tpool = tparse(POOL)
    for i, js in enumerate(_snapshots()):
        if i % 10:
            continue
        ts = state_from_numpy(state_to_numpy(js), device="cpu")
        batched = TREF.drain(ts, tpool.spec)
        for p in range(len(tpool)):
            scalar = tdes.simulate_to_drain(ts, tpool.fork(p))
            _eq(batched.first_started[p].numpy(),
                scalar.first_started.numpy(), f"{i}/{p}")
            _eq(batched.deadlocked[p].numpy(), scalar.deadlocked.numpy(),
                f"{i}/{p}")
            _eq(batched.iters[p].numpy(), scalar.iters.numpy(), f"{i}/{p}")
            for a, b in zip(batched.state.jobs, scalar.state.jobs):
                _eq(a[p].numpy(), b.numpy(), f"{i}/{p}")
            eval_mask = ts.jobs.state == QUEUED
            mb = tdes.state_metrics(
                map_state(lambda x: x[p], batched.state), eval_mask)
            ms = tdes.state_metrics(scalar.state, eval_mask)
            for a, b in zip(mb, ms):
                _eq(a.numpy(), b.numpy(), f"{i}/{p} metrics")


def test_pass_rank_limit_apply_starts_and_helpers():
    js = make_cluster_state(max_jobs=MAX_JOBS, seed=3, n_queued=10,
                            n_running=3)
    k = 4
    jst = jdes.broadcast_state(js, k)
    tst = tdes.broadcast_state(
        state_from_numpy(state_to_numpy(js), device="cpu"), k)
    mask = np.array([True, False, True, True])
    _eq(tdes.pass_rank_limit(tst, torch.from_numpy(mask)).numpy()[0],
        jdes.pass_rank_limit(jst, jnp.asarray(mask)), "limit")
    rng = np.random.default_rng(0)
    started = (rng.random((k, MAX_JOBS)) < 0.2) & (
        np.asarray(js.jobs.state) == QUEUED)[None]
    ja = jdes.apply_starts(jst, jnp.asarray(started))
    ta = tdes.apply_starts(tst, torch.from_numpy(started))
    for a, b in zip(ta.jobs, ja.jobs):
        _eq(a.numpy(), b, "apply_starts")
    _eq(ta.free_nodes.numpy(), ja.free_nodes, "apply_starts free")
    assert ta.free_nodes.dtype == torch.int32
    for q, n in ((0.5, 4), (0.95, 256), (1.0, 7)):
        assert tdes.quantile_index(q, n) == jdes.quantile_index(q, n)
    for a, n in ((0.0, 5), (0.9, 64), (0.99, 10)):
        assert tdes.cvar_tail_count(a, n) == jdes.cvar_tail_count(a, n)
