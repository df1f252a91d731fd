"""Threefry2x32 keys and draws on any torch device — the part of
``jax.random`` that the JAX package calls, bit for bit.

A ``torch.Generator`` cannot reproduce the reference's perturbations, so
the port carries its own copy of JAX's default PRNG (threefry2x32 with
``jax_threefry_partitionable`` on, as jax 0.9 sets it):

* ``PRNGKey(seed)`` — the raw key ``[0, seed mod 2**32]``;
* ``fold_in(key, data)`` — ``threefry(key, [0, data mod 2**32])``;
* ``split(key, n)`` — ``threefry`` of the counters ``(0, i)``, i < n;
* ``bits(key, shape)`` — ``hi ^ lo`` of ``threefry`` over the 64-bit
  iota of ``shape`` split into (hi, lo) 32-bit words;
* ``uniform`` — 23 random mantissa bits under exponent 0, minus one,
  scaled to ``[minval, maxval)``;
* ``normal`` — ``√2 · erf_inv(u)``, u uniform on ``(nextafter(-1, 0), 1)``.

Keys are int64 tensors whose last axis holds the two 32-bit words; any
leading axes batch (``fold_in`` and the draws map over them, as
``jax.vmap`` does in the reference).  The uint32 arithmetic runs in
int64 under a ``0xFFFFFFFF`` mask, which every torch device supports.

Bits, uniforms and normals are bitwise JAX's.  ``erf_inv`` is XLA's f32
form (Giles' single-precision polynomial), not ``torch.erfinv``, which
differs from it in most draws.  Its logarithm and square root, and the
``exp`` that turns a normal into a lognormal factor, are carried here as
XLA evaluates them in f32 on the CPU (``log_f32``, ``log1p_f32``,
``exp_f32``, ``sqrt_f32``): Cephes polynomials with fused multiply-adds
and a correctly rounded root, built only from IEEE-exact operations, so
they give the same bits on every torch device.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike

__all__ = ["PRNGKey", "fold_in", "split", "threefry_2x32", "bits",
           "uniform", "normal", "erf_inv", "log_f32", "log1p_f32",
           "exp_f32", "sqrt_f32", "normal_over_sqrt2"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor):
    """The 20-round threefry2x32 block cipher on broadcastable int64
    tensors of 32-bit words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def PRNGKey(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """The raw (2,) key of an integer seed, as ``jax.random.PRNGKey``
    builds it with 64-bit types off: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _data(data: IntLike, like: torch.Tensor) -> torch.Tensor:
    d = torch.as_tensor(data, device=like.device)
    return d.to(torch.int64) & _MASK


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in`` over any leading key axes: ``data`` is an
    int or an integer tensor broadcast against ``key[..., 0]`` (taken
    mod 2**32, as JAX's uint32 conversion of a traced int32 does)."""
    d = _data(data, key)
    k1, k2 = key[..., 0], key[..., 1]
    shape = torch.broadcast_shapes(k1.shape, d.shape)
    y0, y1 = threefry_2x32(k1, k2, torch.zeros(shape, dtype=torch.int64,
                                               device=key.device), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key: (num, 2) keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry_2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], -1)


def _shape(shape: Union[int, Sequence[int]]) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def bits(key: torch.Tensor, shape: Union[int, Sequence[int]] = ()
         ) -> torch.Tensor:
    """32 random bits (as int64 in [0, 2**32)) of shape
    ``key.shape[:-1] + shape``: threefry over the (hi, lo) words of the
    row-major iota of ``shape``, combined as ``hi ^ lo``."""
    shape = _shape(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry_2x32(k1, k2, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(lead + shape)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from random bits: the top 23 bits as the mantissa of a
    number in [1, 2), minus one."""
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) on ``[minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    f = _unit_floats(bits(key, shape))
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` on f32 operands rounded once to f32, as XLA's
    contracted multiply-add rounds it: the product of two f32s is exact
    in f64, so one f64 add and one rounding give the fused result (a
    double rounding could differ only where the f64 sum lies exactly
    between two f32s)."""
    return (a.double() * _f64(b, a) + _f64(c, a)).float()


def _f64(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.double()
    return torch.tensor(float(np.float32(v)), dtype=torch.float64,
                        device=like.device)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


# ----------------------------------------------------------------------
# The f32 elementary functions as XLA evaluates them on the CPU (Cephes
# polynomials, multiply-adds fused): built from IEEE-exact operations
# only (+, *, fused multiply-add, floor, bit moves), so they give the
# same bits on every torch device.
# ----------------------------------------------------------------------

_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive, finite, normal f32 ``x`` (Cephes logf:
    ``x = m·2^e`` with m in [√½, √2), a degree-8 polynomial in m - 1)."""
    xi = x.view(torch.int32)
    e = 1.0 + ((xi >> 23) - 0x7F).float()
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _c(0.707106781186547524, x)
    t = m - 1.0 + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _c(-2.12194440e-4, x) * e)
    t = _fma(_c(-0.5, x), x2, t)
    t = t + y
    return _fma(_c(0.693359375, x), e, t)


_LOG1P_NUM = (4.5270000862445199635E-5, 4.9854102823193375972E-1,
              6.5787325942061044846E0, 2.9911919328553073277E1,
              6.0949667980987787057E1, 5.7112963590585538103E1,
              2.0039553499201281259E1)
_LOG1P_DEN = (1., 1.5062909083469192198E1, 8.3047565967967209469E1,
              2.2176239823732856465E2, 3.0909872225312059774E2,
              2.1642788614495947685E2, 6.0118660497603843919E1)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` for f32 x > -1 with 1 + x normal: a Cephes rational
    form below |x| = √2 - 1, ``log_f32(1 + x)`` above."""
    xs = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(_c(-0.5, x), xs, (x * xs) * r)
    big = log_f32(torch.clamp(x + 1.0, min=_c(1.17549435e-38, x)))
    return torch.where(x.abs() < _c(0.41421356237309504880, x), small, big)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's; torch's vectorized
    f32 ``sqrt`` on the CPU is off by an ulp in about 0.6% of inputs):
    the f64 root of an f32 rounds to the right f32."""
    return torch.sqrt(x.double()).float()


_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``e**x`` for f32 x (Cephes expf: ``x = a + n·ln 2``, a degree-5
    polynomial in a, times 2**n).  XLA's bits for |x| < 87.3; nearer the
    f32 range's ends (results near 2**-126) the two may part."""
    x = x.clamp(_c(-87.8, x), _c(88.8, x))
    n = torch.floor(_fma(x, 1.44269504088896341, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-_c(0.693359375, x), n, x)
    a = _fma(-_c(-2.12194440e-4, x), n, a)
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = _fma(z, a, c)
    z = 1.0 + _fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 0x7F) << 23).view(torch.float32)
    return z * pow2


# XLA's single-precision erf_inv (Giles 2010), branch w < 5 then w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function of f32 ``x`` in [-1, 1], as XLA lowers
    ``lax.erf_inv``: ``w = -log1p(-x²)``, a degree-8 polynomial in
    ``w - 2.5`` (w < 5) or ``√w - 3``, times x; ±1 map to ±inf."""
    w = -log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    coef = [torch.where(lt, _c(a, x), _c(b, x))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal_over_sqrt2(key: torch.Tensor,
                      shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
    """``erf_inv(u)``: the draws of ``normal`` before their factor √2
    (XLA folds that factor into a following constant multiply)."""
    return erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape: Union[int, Sequence[int]] = ()
           ) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``√2 · erf_inv(u)``."""
    return normal_over_sqrt2(key, shape) * SQRT2_F32
