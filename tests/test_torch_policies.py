"""The port's priority keys, orders and pool grammar against
``repro.core.policies``.

Tolerances:
  * the static fixed points WFP (a=3, b=1, τ=∞), FCFS, SJF, SAF, LJF and
    LXF: bitwise.  Their keys are a one-hot linear term and exact
    products (``x*x*x``), the same f32 operations in both packages;
  * EXPF and the ``expf`` family (through ``expm1``), and wfp sweep
    points with finite τ (through ``exp``) or a ∈ {4, 5} (through
    ``pow``): at most ``MAX_ULP`` = 4 units in the last place.  torch's
    and XLA's CPU transcendental functions are different
    implementations; 4 ulp is the largest difference found on these
    snapshots (expf τ=7200 and EXPF; the wfp sweep reaches 3);
  * orders (stable argsort of the keys): identical, including EXPF's on
    this corpus; for the sweep, asserted wherever the keys are bitwise
    equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backfill as jbf
from repro.core import policies as jpol
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import backfill as tbf
from repro_torch.core import policies as tpol
from repro_torch.core.des import broadcast_state

from conftest import make_cluster_state
from torch_threads import one_thread  # noqa: F401


#: Largest ulp distance between the two packages' keys where they go
#: through pow/exp/expm1 (measured on these snapshots, then held).
MAX_ULP = 4

SWEEP = "wfp:a=1..5x5:tau=600..7200x5,expf:tau=600..7200x3,expf"

_jkeys = jax.jit(jax.vmap(jpol.priority_key_spec, in_axes=(None, None, 0)))
_jid_keys = jax.jit(jax.vmap(jpol.priority_key, in_axes=(None, None, 0)))
_jorder = jax.jit(jax.vmap(jbf.priority_order, in_axes=(None, 0)))


@functools.lru_cache(maxsize=None)
def _corpus():
    """(JAX state, port state) pairs, made once per module."""
    out = []
    for seed in range(30):
        js = make_cluster_state(max_jobs=48, total_nodes=32, seed=seed,
                                n_queued=4 + seed % 20, n_running=seed % 5,
                                now=100.0 + 211.0 * seed)
        out.append((js, state_from_numpy(state_to_numpy(js), device="cpu")))
    return tuple(out)


def _snapshots(n=30):
    return _corpus()[:n]


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 ulps (ordered-integer view)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.max(np.abs(ordered(a) - ordered(b))))


@pytest.mark.parametrize("pid", list(jpol.EXTENDED_POOL),
                         ids=[jpol.POLICY_NAMES[p] for p in jpol.EXTENDED_POOL])
def test_static_keys_and_orders_bitwise(pid):
    ids = jnp.asarray([pid], jnp.int32)
    jspec = jpol.stack_specs([jpol.static_spec(pid)])
    tspec = tpol.stack_specs([tpol.static_spec(pid)])
    for i, (js, ts) in enumerate(_snapshots()):
        ref_id = np.asarray(_jid_keys(js.jobs, js.now, ids))
        ref_spec = np.asarray(_jkeys(js.jobs, js.now, jspec))
        got_id = tpol.priority_key(ts.jobs, ts.now, torch.tensor([pid]))
        got_spec = tpol.priority_key_spec(ts.jobs, ts.now, tspec)
        if pid == jpol.EXPF:   # expm1: ulp-bounded, not bitwise
            assert _ulp(got_id.numpy(), ref_id) <= MAX_ULP
            assert _ulp(got_spec.numpy(), ref_spec) <= MAX_ULP
        else:
            np.testing.assert_array_equal(got_id.numpy(), ref_id,
                                          err_msg=f"snapshot {i}")
            np.testing.assert_array_equal(got_spec.numpy(), ref_spec,
                                          err_msg=f"snapshot {i}")
        np.testing.assert_array_equal(
            tbf.priority_order(ts, tpol.static_spec(pid)).numpy(),
            np.asarray(_jorder(js, jspec))[0], err_msg=f"snapshot {i}")


def test_sweep_keys_within_stated_ulps():
    jpool = jpol.parse_pool(SWEEP)
    tpool = tpol.parse_pool(SWEEP)
    worst = 0
    bitwise_rows = np.ones(len(jpool), bool)
    for js, ts in _snapshots():
        ref = np.asarray(_jkeys(js.jobs, js.now, jpool.spec))
        got = tpol.batched_priority_keys(ts.jobs, ts.now, tpool.spec).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        worst = max(worst, _ulp(got, ref))
        bitwise_rows &= np.all(got == ref, axis=1)
        # where the keys agree bitwise, so do the orders
        same = np.all(got == ref, axis=1)
        ref_o = np.asarray(_jorder(js, jpool.spec))
        got_o = tbf.priority_order(broadcast_state(ts, len(tpool)),
                                   tpool.spec).numpy()
        np.testing.assert_array_equal(got_o[same], ref_o[same])
    assert worst <= MAX_ULP, f"sweep keys differ by {worst} ulp"
    # the integer-exponent, τ=∞ points are bitwise (exact products)
    for i, name in enumerate(jpool.names):
        if name in ("wfp[a=1,tau=inf]",):
            assert bitwise_rows[i], name


def test_wfp_default_point_is_the_paper_wfp_bitwise():
    jspec = jpol.stack_specs([jpol.wfp_spec(3.0, 1.0, np.inf)])
    tspec = tpol.stack_specs([tpol.wfp_spec(3.0, 1.0, np.inf)])
    for js, ts in _snapshots(10):
        np.testing.assert_array_equal(
            tpol.batched_priority_keys(ts.jobs, ts.now, tspec).numpy(),
            np.asarray(_jkeys(js.jobs, js.now, jspec)))


GRAMMARS = ["paper", "extended", "wfp,fcfs,sjf", "wfp:a=2",
            "wfp:a=1..5x5:tau=600..7200x5", "expf:tau=600",
            "lin:est=1:wait=-0.01", "extended,wfp:a=1..5x5:tau=600..7200x5",
            "lin", "wfp", "expf", "saf,ljf,lxf"]


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_parse_pool_round_trips(grammar):
    jp, tp = jpol.parse_pool(grammar), tpol.parse_pool(grammar)
    assert tp.names == jp.names
    np.testing.assert_array_equal(tp.spec.family.numpy(),
                                  np.asarray(jp.spec.family))
    np.testing.assert_array_equal(tp.spec.theta.numpy(),
                                  np.asarray(jp.spec.theta))
    assert tp.spec.family.dtype == torch.int32
    assert tp.spec.theta.dtype == torch.float32
    np.testing.assert_array_equal(tpol.time_invariant_mask(tp.spec),
                                  jpol.time_invariant_mask(jp.spec))
    assert tpol.normalize_pool(tp.spec).names == jpol.normalize_pool(
        jp.spec).names


def test_time_invariant_mask_for_id_pools_and_bad_terms():
    for ids in (jpol.PAPER_POOL, jpol.EXTENDED_POOL, (4, 3, 1)):
        np.testing.assert_array_equal(
            tpol.time_invariant_mask(torch.tensor(ids, dtype=torch.int32)),
            jpol.time_invariant_mask(jnp.asarray(ids, jnp.int32)))
    # trained:<dir> is ported (A9): a missing directory raises as in the
    # reference
    with pytest.raises(FileNotFoundError) as port:
        tpol.parse_pool("trained:some/dir")
    with pytest.raises(FileNotFoundError) as ref:
        jpol.parse_pool("trained:some/dir")
    assert str(port.value) == str(ref.value)
    for bad in ("nope", "fcfs:a=1", "wfp:zz=1", "wfp:a=1..5", "trained:"):
        with pytest.raises(ValueError):
            tpol.parse_pool(bad)


def test_job_features_bitwise():
    """The feature matrix Φ (wait, est, nodes, area, xfactor, submit):
    plain f32 arithmetic, bitwise in both packages."""
    jfeat = jax.jit(jpol.job_features)
    for js, ts in _snapshots(10):
        np.testing.assert_array_equal(
            tpol.job_features(ts.jobs, ts.now).numpy(),
            np.asarray(jfeat(js.jobs, js.now)))
