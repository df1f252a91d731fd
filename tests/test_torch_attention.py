"""The port's attention (``repro_torch.models.attention``) and K4's
wrapper (``repro_torch.kernels.flash_attention``) against the JAX
package's.

* ``full_attention`` (K4's plain version) vs JAX ``full_attention``:
  causal, bidirectional and local; MHA, GQA and MQA; Sq not a multiple
  of ``q_block``; ``q_offset`` > 0.  float32, atol = rtol = 2e-5 (the
  two sum in different orders).
* The K4 wrapper on CPU tensors (its plain version) vs JAX's Pallas
  ``ops.flash_attention`` in interpret mode, at the shapes of
  ``tests/test_kernels_flash.py`` and at recurrentgemma's head dim 256:
  float32 atol = rtol = 2e-5; bfloat16 3e-2, as JAX's own
  ``test_flash_bf16_storage``.
* The K4 wrapper's sliding window (``window=W``; the Pallas kernel has
  none) vs JAX's ``full_attention(local_window=W)``: head dims 64 and
  256, MQA and GQA, W of 16, 100 (not a multiple of the kernel's key
  tile) and wider than the sequence.  float32, 2e-5.
* ``decode_attention`` (with a validity mask) and ``update_cache``
  (including an index past the end, which both clamp) vs JAX.
* K4 itself on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn

TOL = 2e-5


def _qkv(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _j(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,window,q_block,q_offset",
    [(2, 4, 2, 37, 37, 16, True, 0, 16, 0),      # GQA, ragged last block
     (1, 8, 1, 40, 40, 32, False, 0, 16, 0),     # MQA, bidirectional
     (2, 4, 4, 50, 50, 16, True, 8, 16, 0),      # local window
     (1, 4, 2, 12, 40, 16, True, 0, 8, 28),      # q_offset: a later chunk
     (1, 2, 1, 10, 30, 16, True, 6, 4, 20),      # local + q_offset
     (2, 4, 1, 24, 24, 64, True, 0, 512, 0),     # one block
     (1, 4, 1, 70, 70, 256, True, 16, 16, 0)],   # recurrentgemma's local
    ids=["gqa-causal", "mqa-bidir", "local", "q-offset", "local-offset",
         "one-block", "local-d256"])
def test_full_attention_matches_jax(b, hq, hkv, sq, sk, d, causal, window,
                                    q_block, q_offset):
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=sq + sk)
    kw = dict(causal=causal, local_window=window, q_block=q_block,
              q_offset=q_offset)
    want = jattn.full_attention(*_j(q, k, v), **kw)
    got = tattn.full_attention(*_t(q, k, v), **kw)
    assert got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 1, 1, 128, 32),
    (2, 4, 4, 128, 64),
    (2, 4, 2, 256, 32),    # GQA group 2
    (1, 8, 1, 256, 64),    # MQA
    (1, 2, 2, 512, 128),
    (1, 2, 1, 128, 256),   # recurrentgemma's head dim, MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wrapper_matches_pallas_f32(b, hq, hkv, s, d, causal):
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=b * s + d)
    want = ops.flash_attention(*_j(q, k, v), causal=causal, block_q=64,
                               block_k=64)
    launches = fa.LAUNCHES
    got = fa.flash_attention(*_t(q, k, v), causal=causal)
    assert fa.LAUNCHES == launches          # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_flash_wrapper_matches_pallas_bf16():
    q, k, v = _qkv(1, 2, 2, 128, 128, 32, seed=2)
    want = ops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                               causal=True, block_q=64, block_k=64)
    got = fa.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                             causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 10, 1, 200, 256, 100),     # recurrentgemma's heads, W % 64 != 0
    (2, 4, 2, 150, 64, 16),
    (1, 2, 1, 64, 256, 2048),      # W past the sequence: plain causal
    (1, 4, 1, 130, 256, 64)])
def test_flash_wrapper_window_matches_jax(b, hq, hkv, s, d, window):
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=s + window)
    want = jattn.full_attention(*_j(q, k, v), causal=True,
                                local_window=window, q_block=64)
    launches = fa.LAUNCHES
    got = fa.flash_attention(*_t(q, k, v), causal=True, window=window)
    assert fa.LAUNCHES == launches          # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the window implies causal, as local_window does
    got = fa.flash_attention(*_t(q, k, v), causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(*_t(q, k, v), window=-1)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
def test_decode_attention_matches_jax(hq, hkv):
    b, s, d = 3, 20, 16
    q, k, v = _qkv(b, hq, hkv, 1, s, d, seed=hq * 10 + hkv)
    valid = np.arange(s)[None, :] <= np.array([[5], [19], [11]])
    want = jattn.decode_attention(*_j(q, k, v),
                                  kv_valid=jnp.asarray(valid))
    got = tattn.decode_attention(*_t(q, k, v),
                                 kv_valid=torch.from_numpy(valid))
    assert got.shape == (b, hq, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # bf16 cache, f32 query: probabilities rounded to the cache's dtype
    want = jattn.decode_attention(*_j(q), *_j(k, v, dtype=jnp.bfloat16),
                                  kv_valid=jnp.asarray(valid))
    got = tattn.decode_attention(*_t(q), *_t(k, v, dtype=torch.bfloat16),
                                 kv_valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("index", [0, 7, 11, 15])
def test_update_cache_matches_jax(index):
    rng = np.random.default_rng(index)
    kc, vc = (rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 3, 1, 8)).astype(np.float32)
              for _ in range(2))
    jk, jv = jattn.update_cache(*_j(kc, vc, kn, vn), jnp.int32(index))
    tk, tv = _t(kc, vc)
    out = tattn.update_cache(tk, tv, *_t(kn, vn), index)
    assert out[0] is tk and out[1] is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _strided(shape, index, dtype=torch.bfloat16):
    """A view ``base[index]`` of a fresh (B, S, H, D)-ordered tensor,
    returned as (B, H, S, D)."""
    return torch.zeros(shape, dtype=dtype)[index].transpose(1, 2)


@pytest.mark.parametrize("name,t,ready", [
    ("contiguous", torch.zeros((2, 4, 100, 64), dtype=torch.bfloat16), True),
    ("projection view", _strided((2, 100, 4, 64), slice(None)), True),
    ("fused qkv slice", _strided((2, 100, 12, 64),
                                 (slice(None), slice(None), slice(4, 8))),
     True),
    ("head dim strided", torch.zeros((1, 2, 8, 128),
                                     dtype=torch.bfloat16)[..., ::2], False),
    ("rows 120 bytes apart", _strided((1, 10, 4, 60),
                                      (Ellipsis, slice(0, 56))), False),
    ("base off 16 bytes", torch.zeros((1, 2, 8, 72),
                                      dtype=torch.bfloat16)[..., 4:68],
     False),
    ("expanded kv heads", torch.zeros((1, 1, 8, 64),
                                      dtype=torch.bfloat16).expand(
                                          1, 4, 8, 64), False),
    ("stride 0 on a dim of 1", torch.zeros((1, 4, 8, 64),
                                           dtype=torch.bfloat16).expand(
                                               1, 4, 8, 64).as_strided(
                                                   (1, 4, 8, 64),
                                                   (0, 512, 64, 1)), True),
    ("float32 rows of 16 bytes", torch.zeros((1, 2, 8, 4)), True),
])
def test_flash_wrapper_tma_alignment(name, t, ready):
    """The rule for handing a tensor to the kernel's TMA maps in place:
    head dim contiguous, base 16-byte aligned, strides multiples of 16
    bytes and nonzero where the dim has more than one entry; anything
    else is copied to a contiguous tensor, which passes."""
    assert fa.tma_ready(t) == ready, name
    got = fa._aligned(t)
    assert (got is t) == ready
    assert fa.tma_ready(got) and torch.equal(got, t)


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.bfloat16, 32, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 96, False), (torch.bfloat16, 512, False),
    (torch.float32, 32, True), (torch.float32, 128, True),
    (torch.float32, 256, False), (torch.float32, 16, False)])
def test_flash_wrapper_head_dim_table(dtype, d, ok):
    """The head dims each dtype takes (float32 stops at 128; the bf16
    kernel has a plan for each of its own), and the error for the
    others."""
    assert (d in fa.HEAD_DIMS[dtype]) == ok
    q = torch.zeros((1, 4, 8, d), dtype=dtype)
    k = torch.zeros((1, 2, 8, d), dtype=dtype)
    if ok:
        fa.check_inputs(q, k, k)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa.check_inputs(q, k, k)
    assert sorted(fa.PLAN) == sorted(fa.HEAD_DIMS[torch.bfloat16])


@pytest.mark.parametrize("q_shape,k_shape,v_shape,dtypes,error", [
    ((1, 4, 8, 64), (1, 3, 8, 64), (1, 3, 8, 64), None, ValueError),
    ((1, 4, 8, 64), (2, 2, 8, 64), (2, 2, 8, 64), None, ValueError),
    ((1, 4, 8, 64), (1, 2, 8, 32), (1, 2, 8, 32), None, ValueError),
    ((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 9, 64), None, ValueError),
    ((4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64), None, ValueError),
    ((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64),
     (torch.float16,) * 3, TypeError),
    ((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64),
     (torch.bfloat16, torch.float32, torch.bfloat16), TypeError)],
    ids=["heads", "batch", "head-dim", "v-shape", "rank", "float16",
         "mixed"])
def test_flash_wrapper_refuses(q_shape, k_shape, v_shape, dtypes, error):
    """Shapes and dtypes the kernel refuses raise before any launch."""
    dq, dk, dv = dtypes or (torch.bfloat16,) * 3
    with pytest.raises(error, match="flash_attention"):
        fa.check_inputs(torch.zeros(q_shape, dtype=dq),
                        torch.zeros(k_shape, dtype=dk),
                        torch.zeros(v_shape, dtype=dv))


@pytest.mark.parametrize("d,block_n,stages,nbytes", [
    (32, 128, 3, 58624), (64, 128, 3, 115968), (128, 128, 2, 165120),
    (256, 64, 2, 197888)])
def test_flash_plan_fits_shared_memory(d, block_n, stages, nbytes):
    """The bf16 kernel's plan per head dim (key tile, ring stages) and
    its shared memory, which must fit the 227 KB a block may use; the
    key tile is a multiple of wgmma's 16-key step and the Q tile two
    warpgroups of 64 rows."""
    assert fa.PLAN[d] == (block_n, stages)
    assert fa.smem_bytes(d) == nbytes <= fa.SMEM_LIMIT == 227 * 1024
    assert block_n % 16 == 0 and fa.BLOCK_Q == 2 * 64
