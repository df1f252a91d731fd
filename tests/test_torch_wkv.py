"""The port's WKV6 recurrence (``repro_torch.models.blocks_rnn``) and K3's
wrapper (``repro_torch.kernels.wkv6``) against the JAX package's.

* ``wkv_step`` and ``wkv_scan`` (K3's plain version) vs JAX's
  ``wkv_step``/``wkv_scan``, from a zero and from a random state, at the
  shapes of ``tests/test_kernels_recurrent.py`` and at S not a multiple
  of 128 (where JAX's scan takes its unchunked branch).
* The K3 wrapper on CPU tensors (its plain version) vs JAX's Pallas
  ``ops.wkv6`` in interpret mode.
* Tolerance everywhere: atol = rtol = 2e-4, that of
  ``tests/test_kernels_recurrent.py`` (f32 sums over N in another order,
  compounded over S steps).
* ``wkv_chunked`` (the chunk algebra K3 runs on the card) vs JAX's
  ``wkv_chunked`` and vs the port's ``wkv_scan``: chunks of 32 and 16, S
  divisible by the chunk and not (JAX then falls back to its scan; the
  port pads the last chunk as K3 does), zero and random states, and
  decays made as ``rwkv_time_mix`` makes them, w = exp(-exp(x)), with x
  spread until w holds exact zeros and exact ones.
* K3 itself on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import blocks_rnn as jrnn
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import blocks_rnn as trnn

TOL = 2e-4


def _inputs(b, s, h, n, seed):
    """r, k, v ~ N(0, 1); w = sigmoid(N(0, 1)) in (0, 1); u (H, N)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h, n))))).astype(
        np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


SHAPES = [(1, 32, 1, 8), (2, 64, 2, 16), (2, 128, 4, 32), (1, 256, 2, 64),
          (2, 200, 2, 16),      # S not a multiple of 128
          (1, 37, 3, 16)]


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero", "state"])
@pytest.mark.parametrize("b,s,h,n", SHAPES)
def test_wkv_scan_matches_jax(b, s, h, n, zero_state):
    r, k, v, w, u = _inputs(b, s, h, n, seed=b * s + n)
    state = np.zeros((b, h, n, n), np.float32)
    if not zero_state:
        state = np.random.default_rng(1).standard_normal(
            (b, h, n, n)).astype(np.float32)
    jst, jy = jrnn.wkv_scan(*(jnp.asarray(a) for a in
                              (state, r, k, v, w, u)))
    tst, ty = trnn.wkv_scan(*(torch.from_numpy(a) for a in
                              (state, r, k, v, w, u)))
    assert ty.shape == (b, s, h, n) and tst.shape == (b, h, n, n)
    _close(ty, jy)
    _close(tst, jst)


def test_wkv_step_matches_jax():
    r, k, v, w, u = _inputs(3, 1, 4, 16, seed=5)
    state = np.random.default_rng(6).standard_normal(
        (3, 4, 16, 16)).astype(np.float32)
    args = (state, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
    jst, jy = jrnn.wkv_step(*(jnp.asarray(a) for a in args))
    tst, ty = trnn.wkv_step(*(torch.from_numpy(a) for a in args))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("b,s,h,n,block_t", [
    (1, 32, 1, 8, 16), (2, 64, 2, 16, 64), (2, 128, 4, 32, 16),
    (1, 256, 2, 64, 64), (2, 200, 2, 16, 8)])
def test_wkv6_wrapper_matches_pallas(b, s, h, n, block_t):
    r, k, v, w, u = _inputs(b, s, h, n, seed=s + n)
    jy, jst = ops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                       block_t=block_t)
    launches = wk.LAUNCHES
    ty, tst = wk.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    assert wk.LAUNCHES == launches          # CPU tensors: the plain version
    _close(ty, jy)
    _close(tst, jst)


CHUNKED_SHAPES = [(1, 64, 2, 16, 32), (2, 64, 2, 16, 16), (1, 96, 3, 32, 32),
                  (2, 100, 2, 16, 32),   # S not a multiple of the chunk
                  (1, 37, 2, 64, 16), (2, 7, 1, 16, 16)]


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero", "state"])
@pytest.mark.parametrize("b,s,h,n,chunk", CHUNKED_SHAPES)
def test_wkv_chunked_matches_jax_and_scan(b, s, h, n, chunk, zero_state):
    r, k, v, w, u = _inputs(b, s, h, n, seed=3 * s + n + chunk)
    state = np.zeros((b, h, n, n), np.float32)
    if not zero_state:
        state = np.random.default_rng(2).standard_normal(
            (b, h, n, n)).astype(np.float32)
    args = (state, r, k, v, w, u)
    jst, jy = jrnn.wkv_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    targs = tuple(torch.from_numpy(a) for a in args)
    tst, ty = trnn.wkv_chunked(*targs, chunk=chunk)
    sst, sy = trnn.wkv_scan(*targs)
    assert ty.shape == (b, s, h, n) and tst.shape == (b, h, n, n)
    _close(ty, jy)
    _close(tst, jst)
    _close(ty, sy)
    _close(tst, sst)


def _model_decays(b, s, h, n, seed):
    """w = exp(-exp(x)) as ``rwkv_time_mix`` makes it, x spread over
    [-30, 6]: w runs from exact 1.0 (x below ~-17) to exact 0 (x above
    ~4.5)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-30.0, 6.0, (b, s, h, n)).astype(np.float32)
    w = torch.exp(-torch.exp(torch.from_numpy(x)))
    return w.numpy()


@pytest.mark.parametrize("s,chunk", [(16, 16), (17, 16), (48, 32),
                                     (50, 16)])
def test_wkv_chunked_extreme_decays(s, chunk):
    r, k, v, _, u = _inputs(2, s, 2, 32, seed=s)
    w = _model_decays(2, s, 2, 32, seed=s + 1)
    assert (w == 0.0).any() and (w == 1.0).any()
    state = np.random.default_rng(s).standard_normal(
        (2, 2, 32, 32)).astype(np.float32)
    targs = tuple(torch.from_numpy(a) for a in (state, r, k, v, w, u))
    tst, ty = trnn.wkv_chunked(*targs, chunk=chunk)
    sst, sy = trnn.wkv_scan(*targs)
    assert torch.isfinite(ty).all() and torch.isfinite(tst).all()
    _close(ty, sy)
    _close(tst, sst)
    jst, jy = jrnn.wkv_chunked(*(jnp.asarray(a) for a in
                                 (state, r, k, v, w, u)), chunk=chunk)
    _close(ty, jy)
    _close(tst, jst)
