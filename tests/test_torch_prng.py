"""The port's threefry PRNG (``repro_torch.core.prng``) against
``jax.random`` on the CPU.

Keys, ``fold_in`` (data from 0 to 2**32 - 1, negative int32 data wrapped
as JAX's uint32 conversion wraps it, ``fan._DOMAIN_TAG``), ``split``,
bits and uniforms (over shapes (), (2,), (1024,) and (3, 5), seeds up to
2**40 and batched keys): identical.  Normals: identical too — the port
evaluates XLA's f32 ``erf_inv``, ``log1p`` and ``sqrt`` rather than
torch's (``torch.erfinv`` differed in 59% of 200k draws, by up to 88
ulp); the count of differing draws is asserted to be 0 over 800k
draws.  ``exp_f32`` (the lognormal factor's ``exp``): identical to
``jnp.exp`` on 800k arguments in (-87, 87); ``log_f32``, ``log1p_f32``
and ``sqrt_f32``: identical to ``jnp.log``/``log1p``/``sqrt``.
``sin_f32`` (glibc's ``sinf``, which XLA's f32 ``sin`` is on the CPU):
identical to ``jnp.sin`` on ~1.3M arguments over every branch and in a
hypothesis test over ±1e5 and the region around 120 rad.  A hypothesis
test draws seeds, fold-in chains and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fan as jfan
from repro_torch.core import fan as tfan
from repro_torch.core import prng

SHAPES = [(), (2,), (1024,), (3, 5)]
SEEDS = [0, 1, 42, 7919, 2**31 - 1, 2**31, 2**32 + 5, 2**40 + 3]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32),
                                      b.astype(np.float32).view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    _same_bits(jax.random.PRNGKey(seed), prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2**31 - 1, 2**31,
                                  2**32 - 1, jfan._DOMAIN_TAG])
def test_fold_in_matches_jax(data):
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    _same_bits(jax.random.fold_in(jk, data), prng.fold_in(tk, data).numpy())
    assert tfan._DOMAIN_TAG == jfan._DOMAIN_TAG


def test_fold_in_negative_int32_data_wraps_as_jax():
    """A traced int32 (a vmapped scenario or member id) converts to
    uint32 with wrap-around in JAX: -1 folds in as 2**32 - 1."""
    jk, tk = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for d in (-1, -7, -(2**31)):
        got = prng.fold_in(tk, torch.tensor(d, dtype=torch.int32)).numpy()
        _same_bits(jax.jit(jax.random.fold_in)(jk, jnp.int32(d)), got)


def test_batched_fold_in_chain_matches_vmapped_jax():
    """``_member_draws``' key chain over a (B,) batch of (s, φ) pairs, as
    the reference vmaps it."""
    s = np.array([0, 0, 1, 3, 7, 2], np.int32)
    phi = np.array([0, 5, 1, 63, 2, 0], np.int32)
    jk = jax.vmap(lambda a, b: jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(11), a), b))(jnp.asarray(s), jnp.asarray(phi))
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(11), torch.as_tensor(s)),
                      torch.as_tensor(phi))
    _same_bits(jk, tk.numpy())


@pytest.mark.parametrize("num", [1, 2, 3, 17])
def test_split_matches_jax(num):
    for seed in (0, 12345):
        _same_bits(jax.random.split(jax.random.PRNGKey(seed), num),
                   prng.split(prng.PRNGKey(seed), num).numpy())


def test_twin_key_chain_matches_jax():
    """The twin's ``key, sub = split(key)`` chain, ten links deep."""
    jk, tk = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for _ in range(10):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        _same_bits(jsub, tsub.numpy())
        _same_bits(jk, tk.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5])
def test_bits_and_uniform_match_jax(shape, seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same_bits(jax.random.bits(jk, shape), prng.bits(tk, shape).numpy())
    _same_bits(jax.random.uniform(jk, shape),
               prng.uniform(tk, shape).numpy())
    _same_bits(jax.random.uniform(jk, shape, minval=0.0,
                                  maxval=2.0 * np.pi),
               prng.uniform(tk, shape, 0.0, 2.0 * np.pi).numpy())
    _same_bits(jax.random.normal(jk, shape), prng.normal(tk, shape).numpy())


def test_batched_draws_match_vmapped_jax():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    tkeys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    _same_bits(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys),
               prng.uniform(tkeys, (2,)).numpy())
    _same_bits(jax.vmap(lambda k: jax.random.normal(k, (300,)))(keys),
               prng.normal(tkeys, (300,)).numpy())
    _same_bits(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys),
               prng.uniform(tkeys, ()).numpy())


def test_normals_bitwise_over_many_draws():
    """800k normals from four fold-in chains: the count of draws that
    differ from ``jax.random.normal`` is 0 (bound: 0 ulp)."""
    differ = 0
    for seed in (0, 9):
        for tag in (0, 1):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
            tk = prng.fold_in(prng.PRNGKey(seed), tag)
            a = np.asarray(jax.random.normal(jk, (200_000,)))
            b = prng.normal(tk, (200_000,)).numpy()
            differ += int((a.view(np.uint32) != b.view(np.uint32)).sum())
    assert differ == 0


def test_torch_erfinv_is_not_the_reference():
    """Why ``prng.erf_inv`` exists: torch's ``erfinv`` gives other bits
    than XLA's on most draws (measured: 59% of 200k)."""
    jk, tk = jax.random.PRNGKey(0), prng.PRNGKey(0)
    a = np.asarray(jax.random.normal(jk, (20_000,)))
    u = prng.uniform(tk, (20_000,), prng._NORMAL_LO, 1.0)
    b = (torch.erfinv(u) * prng.SQRT2_F32).numpy()
    assert (a.view(np.uint32) != b.view(np.uint32)).mean() > 0.2
    _same_bits(a, (prng.erf_inv(u) * prng.SQRT2_F32).numpy())


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    _same_bits(want, got)


def test_exp_log_sqrt_match_xla():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (400_000,)))
    wide = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (400_000,),
                                         minval=-87.0, maxval=87.0))
    xs = np.concatenate([x * np.float32(0.3), wide])
    _same_bits(jax.jit(jnp.exp)(jnp.asarray(xs)),
               prng.exp_f32(torch.tensor(xs)).numpy())
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (200_000,),
                                        minval=1e-30, maxval=1e4))
    _same_bits(jax.jit(jnp.log)(jnp.asarray(pos)),
               prng.log_f32(torch.tensor(pos)).numpy())
    _same_bits(jax.jit(jnp.sqrt)(jnp.asarray(pos)),
               prng.sqrt_f32(torch.tensor(pos)).numpy())
    m = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (200_000,),
                                      minval=-0.9999, maxval=0.0))
    _same_bits(jax.jit(jnp.log1p)(jnp.asarray(m)),
               prng.log1p_f32(torch.tensor(m)).numpy())


def _sin_both(xs):
    xs = np.asarray(xs, np.float32)
    _same_bits(jax.jit(jnp.sin)(jnp.asarray(xs)),
               prng.sin_f32(torch.tensor(xs)).numpy())


def test_sin_matches_xla_over_its_paths():
    """``sin_f32`` against ``jnp.sin`` (C11): every branch of glibc's
    ``sinf`` — |x| < 2**-12, < 0.75, the fast reduction below 120, the
    4/pi-table reduction above, up to the f32 maximum — and the burst
    warp's own arguments ``omega * submit + phase``."""
    rng = np.random.default_rng(0)
    big = rng.integers(0, 0x7F800000, 200_000).astype(np.uint32)
    warp = (2 * np.pi / rng.uniform(600.0, 900.0, 100_000)) * \
        rng.uniform(0.0, 5e4, 100_000) + rng.uniform(0, 2 * np.pi, 100_000)
    _sin_both(np.concatenate([
        rng.uniform(-1e5, 1e5, 400_000), rng.uniform(-130.0, 130.0, 200_000),
        rng.uniform(119.0, 121.0, 50_000), -rng.uniform(119.0, 121.0, 50_000),
        rng.uniform(-1.0, 1.0, 50_000), rng.uniform(-3e-4, 3e-4, 10_000),
        big.view(np.float32), -big.view(np.float32), warp,
        [0.0, -0.0, 0.75, -0.75, 2.0**-12, 120.0, -120.0, 1e-45, 3e38]]))


def test_sin_edges():
    xs = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    assert torch.isnan(prng.sin_f32(xs)).all()
    z = prng.sin_f32(torch.tensor([0.0, -0.0])).numpy()
    assert z.view(np.uint32).tolist() == [0, 0x80000000]


def test_hypothesis_sin_matches_xla():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    f32 = dict(width=32, allow_nan=False, allow_infinity=False)

    @settings(max_examples=60, deadline=None)
    @given(xs=st.lists(st.one_of(st.floats(-1e5, 1e5, **f32),
                                 st.floats(110.0, 130.0, **f32),
                                 st.floats(-130.0, -110.0, **f32)),
                       min_size=1, max_size=64))
    def run(xs):
        _sin_both(xs)

    run()


def test_hypothesis_seeds_chains_and_shapes():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**40),
           chain=st.lists(st.integers(0, 2**32 - 1), max_size=3),
           shape=st.lists(st.integers(1, 9), max_size=3))
    def run(seed, chain, shape):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for d in chain:
            jk, tk = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
        shape = tuple(shape)
        _same_bits(jk, tk.numpy())
        _same_bits(jax.random.bits(jk, shape), prng.bits(tk, shape).numpy())
        _same_bits(jax.random.uniform(jk, shape),
                   prng.uniform(tk, shape).numpy())
        _same_bits(jax.random.normal(jk, shape),
                   prng.normal(tk, shape).numpy())

    run()


def test_member_draws_match_reference():
    """``fan._member_draws`` (the reference's normals, phase and uniform
    pair, vmapped over (s, φ)) and the domain fragilities."""
    s = jnp.asarray([0, 0, 1, 2, 2], jnp.int32)
    phi = jnp.asarray([0, 3, 1, 0, 7], jnp.int32)
    eps, phase, u = jax.vmap(
        lambda a, b: jfan._member_draws(13, a, b, 64))(s, phi)
    z, tphase, tu = tfan._member_draws(
        13, torch.as_tensor(np.asarray(s)), torch.as_tensor(np.asarray(phi)),
        64)
    _same_bits(eps, (z * prng.SQRT2_F32).numpy())
    _same_bits(phase, tphase.numpy())
    _same_bits(u, tu.numpy())
    q = jax.vmap(lambda a: jfan._domain_fragility(13, a, 6))(jnp.arange(4))
    _same_bits(q, tfan._domain_fragility(13, torch.arange(4), 6).numpy())
