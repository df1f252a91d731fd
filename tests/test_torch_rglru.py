"""The port's RG-LRU recurrence (``repro_torch.models.blocks_rnn``) and K2's
wrapper (``repro_torch.kernels.rglru``) against the JAX package's.

* ``rglru_scan`` (K2's plain version) vs JAX's ``rglru_scan``, from a
  zero and from a nonzero h0, at the shapes of
  ``tests/test_kernels_recurrent.py``, at S not a multiple of any block
  (and of JAX's scan chunk, where it takes its unchunked branch), and at
  a ragged width.  Both return ``(h_final, h_all)``.
* The K2 wrapper on CPU tensors (its plain version) vs JAX's Pallas
  ``ops.rglru`` in interpret mode, which returns ``(h_all, h_final)``,
  as the wrapper does.  The Pallas wrapper asserts S % block_t == 0 and
  W % block_w == 0; the port's wrapper takes any S and W (checked against
  ``rglru_scan`` above).
* Tolerance everywhere: atol = rtol = 1e-5, that of
  ``tests/test_kernels_recurrent.py`` (XLA may contract a * h + x into
  one FMA where torch rounds twice, compounded over S steps).
* K2 itself on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import blocks_rnn as jrnn
from repro_torch.kernels import rglru as rg
from repro_torch.models import blocks_rnn as trnn

TOL = 1e-5


def _inputs(b, s, w, seed, h0_scale):
    """a = sigmoid(N(0, 1)) in (0, 1); x ~ N(0, 1); h0 = h0_scale N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))).astype(
        np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = (h0_scale * rng.standard_normal((b, w))).astype(np.float32)
    return a, x, h0


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


SHAPES = [(1, 32, 16), (2, 128, 64), (2, 256, 256), (4, 64, 128),
          (2, 200, 64),        # S not a multiple of 128 or of any block
          (1, 37, 24),         # ragged S and W
          (3, 300, 40)]        # S past JAX's scan chunk, not a multiple


@pytest.mark.parametrize("h0_scale", [0.0, 5.0], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,w", SHAPES)
def test_rglru_scan_matches_jax(b, s, w, h0_scale):
    a, x, h0 = _inputs(b, s, w, seed=s + w, h0_scale=h0_scale)
    j_final, j_all = jrnn.rglru_scan(*(jnp.asarray(t) for t in (a, x, h0)))
    t_final, t_all = trnn.rglru_scan(*(torch.from_numpy(t)
                                       for t in (a, x, h0)))
    assert t_all.shape == (b, s, w) and t_final.shape == (b, w)
    assert t_all.dtype == torch.float32
    _close(t_all, j_all)
    _close(t_final, j_final)


@pytest.mark.parametrize("h0_scale", [0.0, 5.0], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,w,block_t,block_w", [
    (1, 32, 16, 16, 16), (2, 128, 64, 64, 64), (2, 256, 256, 16, 16),
    (4, 64, 128, 64, 64), (2, 64, 32, 16, 16)])
def test_rglru_wrapper_matches_pallas(b, s, w, block_t, block_w, h0_scale):
    a, x, h0 = _inputs(b, s, w, seed=b * s + w, h0_scale=h0_scale)
    j_all, j_final = ops.rglru(*(jnp.asarray(t) for t in (a, x, h0)),
                               block_t=block_t, block_w=block_w)
    launches = rg.LAUNCHES
    t_all, t_final = rg.rglru(*(torch.from_numpy(t) for t in (a, x, h0)))
    assert rg.LAUNCHES == launches          # CPU tensors: the plain version
    _close(t_all, j_all)
    _close(t_final, j_final)


def test_rglru_wrapper_takes_ragged_shapes():
    """What the Pallas wrapper refuses (S % block_t, W % block_w), the
    port's takes: the CPU path is ``rglru_scan`` in the Pallas order."""
    a, x, h0 = _inputs(2, 37, 24, seed=3, h0_scale=1.0)
    t_all, t_final = rg.rglru(*(torch.from_numpy(t) for t in (a, x, h0)))
    s_final, s_all = trnn.rglru_scan(*(torch.from_numpy(t)
                                       for t in (a, x, h0)))
    assert torch.equal(t_all, s_all) and torch.equal(t_final, s_final)
    with pytest.raises(AssertionError):
        ops.rglru(*(jnp.asarray(t) for t in (a, x, h0)), block_t=16,
                  block_w=16)
