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
they give the same bits on every torch device.  XLA's f32 ``sin`` on the
CPU is glibc's ``sinf`` (its x86-64 FMA build); ``sin_f32`` carries that
one, with the f64 fused multiply-adds emulated exactly.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike

__all__ = ["PRNGKey", "fold_in", "split", "threefry_2x32", "bits",
           "uniform", "normal", "erf_inv", "log_f32", "log1p_f32",
           "exp_f32", "sqrt_f32", "sin_f32", "normal_over_sqrt2",
           "key_words"]

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


def _threefry_2x32_int32(k1: torch.Tensor, k2: torch.Tensor,
                        x0: torch.Tensor, x1: torch.Tensor):
    """``threefry_2x32`` on int32 tensors holding the 32-bit words as
    two's complement: additions wrap modulo 2**32, and a rotation's
    right shift (arithmetic on int32) is masked to a logical one.  The
    bulk draws run here, in place where they can: half the bytes of the
    int64 form and no temporaries, with the same bits."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            hi = x1 << r
            x1 >>= 32 - r
            x1 &= (1 << r) - 1
            x1 |= hi
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def PRNGKey(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """The raw (2,) key of an integer seed, as ``jax.random.PRNGKey``
    builds it with 64-bit types off: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def key_words(key: torch.Tensor) -> np.ndarray:
    """A key's words as the host uint32 array the JAX package holds (and
    checkpoints) for it; ``CheckpointManager.restore`` turns them back
    into an int64 key."""
    return key.detach().cpu().numpy().astype(np.uint32)


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


def _bits_int32(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
                offset: int = 0) -> torch.Tensor:
    """``bits`` as int32 tensors holding the 32-bit words."""
    shape = _shape(shape)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].to(torch.int32).reshape(lead + (1,))
    k2 = key[..., 1].to(torch.int32).reshape(lead + (1,))
    y0, y1 = _threefry_2x32_int32(k1, k2, (idx >> 32).to(torch.int32),
                                  idx.to(torch.int32))
    y0 ^= y1
    return y0.reshape(lead + shape)


def bits(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
         offset: int = 0) -> torch.Tensor:
    """32 random bits (as int64 in [0, 2**32)) of shape
    ``key.shape[:-1] + shape``: threefry over the (hi, lo) words of the
    row-major iota of ``shape``, combined as ``hi ^ lo``.  ``offset``
    starts the iota there: the draws of the flat elements ``[offset,
    offset + prod(shape))`` of a larger shape, so a large draw can be
    made chunk by chunk with the same bits."""
    return _bits_int32(key, shape, offset).to(torch.int64) & _MASK


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from random bits (int32 words): the top 23 bits as the
    mantissa of a number in [1, 2), minus one."""
    fb = ((b >> 9) & 0x7FFFFF) | 0x3F800000
    return fb.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
            minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) on ``[minval, maxval)``;
    ``offset`` as ``bits``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    f = _unit_floats(_bits_int32(key, shape, offset))
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` on f32 operands rounded once to f32, as XLA's
    contracted multiply-add rounds it: the product of two f32s is exact
    in f64, so one f64 add and one rounding give the fused result (a
    double rounding could differ only where the f64 sum lies exactly
    between two f32s).  One ``addcmul`` in f64: a scalar (or 0-d)
    operand goes in as a one-element f64 tensor, which makes the whole
    product f64 without converting the large operands first."""
    tensors = [v for v in (a, b, c) if isinstance(v, torch.Tensor)]
    dev = tensors[0].device
    shape = torch.broadcast_shapes(*(v.shape for v in tensors))
    ops = [_f64(v, dev) if not isinstance(v, torch.Tensor) or v.dim() == 0
           else v for v in (a, b, c)]
    if all(v.dtype != torch.float64 for v in ops):
        ops[2] = ops[2].double()
    return torch.addcmul(ops[2], ops[0], ops[1]).float().reshape(shape)


def _f64(v, device: torch.device) -> torch.Tensor:
    """A scalar (or 0-d tensor) as a one-element f64 tensor holding its
    f32 value."""
    if isinstance(v, torch.Tensor):
        return v.float().double().reshape(1)
    return torch.full((1,), float(np.float32(v)), dtype=torch.float64,
                      device=device)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """f32 constant on ``like``'s device (filled there: no copy from
    the host)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
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


# ----------------------------------------------------------------------
# glibc's sinf (sysdeps/ieee754/flt-32/s_sinf.c, sincosf.h), which XLA
# calls for an f32 sin on the CPU: the argument goes to f64, is reduced
# to [-pi/4, pi/4] (one multiply-subtract below 120, the 4/pi bit table
# above), and a sine or cosine polynomial is evaluated in f64 and rounded
# once to f32.  The x86-64 build glibc picks on an FMA host fuses each
# ``a + b*c``; ``_fma64`` fuses them too, exactly, from IEEE-exact f64
# operations (Dekker's product, Knuth's sum and Boldo-Melquiond's
# rounding to odd).
# ----------------------------------------------------------------------

def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _veltkamp(a: torch.Tensor):
    c = a * 134217729.0                           # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_round_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` rounded to odd: an inexact sum takes whichever f64
    neighbour of the exact value has an odd last bit."""
    s, e = _two_sum(a, b)
    sb = s.view(torch.int64)
    step = torch.where((s < 0) == (e < 0), 1, -1)
    fix = (e != 0) & ((sb & 1) == 0)
    return torch.where(fix, (sb + step).view(torch.float64), s)


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in f64 rounded once (Boldo and Melquiond, 2008):
    the exact product and sum as pairs, their low parts added with
    rounding to odd, then one rounding to nearest."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_round_odd(tl, ul)


_HPI_INV_2P24 = float.fromhex("0x1.45F306DC9C883p+23")      # 2/pi * 2**24
_HPI = float.fromhex("0x1.921FB54442D18p0")                  # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")               # 2pi * 2**-64
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_SIN_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
# 4/pi to 192 bits; entry i holds bits [8i - 24, 8i + 8) of it
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)


def _reduce_large(yi: torch.Tensor):
    """glibc's ``reduce_large``: |y| (f32 bits ``yi`` as int64) mod pi/2
    from a 32 x 96-bit product with the 4/pi table, in 2.62 fixed point.
    The 64-bit words are kept as (hi, lo) 32-bit halves in int64.
    Returns the reduced f64 and the quadrant."""
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=yi.device)
    i = (yi >> 26) & 15
    m = ((yi & 0xFFFFFF) | 0x800000) << ((yi >> 23) & 7)      # < 2**31
    r0 = (m * tab[i]) & _MASK                   # the low word of res0
    r1 = m * tab[i + 4]
    lo = (m * tab[i + 8]) >> 32
    lo = lo + (r1 & _MASK)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & _MASK
    lo = lo & _MASK
    n = ((hi + (1 << 29)) & _MASK) >> 30        # (res0 + 2**61) >> 62
    hi = (hi - (n << 30)) & _MASK
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return (hi * (1 << 32) + lo).double() * _PI63, n


def sin_f32(y: torch.Tensor) -> torch.Tensor:
    """``sin`` of f32 ``y`` as glibc's ``sinf`` (FMA build) computes it,
    bit for bit: the value XLA's f32 ``sin`` takes on the CPU."""
    yi = y.view(torch.int32).to(torch.int64) & _MASK
    top = (yi >> 20) & 0x7FF                    # glibc's abstop12
    x = y.double()
    # below 120: one multiply-subtract by pi/2 (2/pi prescaled by 2**24)
    n_fast = ((x * _HPI_INV_2P24).to(torch.int64) + 0x800000) >> 24
    r_fast = _fma64(-n_fast.double(), _HPI, x)
    r_large, n_large = _reduce_large(yi)
    small = top < 0x3F4                         # |y| < 0.75: no reduction
    fast = top < 0x42F                          # |y| < 120
    n = torch.where(small, 0, torch.where(fast, n_fast, n_large))
    # the sign's quadrant; the large reduction ran on |y|
    q = torch.where(fast, n, n_large + (yi >> 31))
    r = torch.where(small, x, torch.where(fast, r_fast, r_large))
    neg = ((q & 3) == 1) | ((q & 3) == 2)
    xs = torch.where(neg & ~small, -r, r)
    x2 = r * r
    # sine polynomial for even n, cosine (negated where q & 2) for odd
    x3 = xs * x2
    s = _fma64(x3 * x2, _fma64(x2, _SIN_S[2], _SIN_S[1]),
               _fma64(x3, _SIN_S[0], xs))
    cs = torch.where((q & 2) != 0, -1.0, 1.0).double()
    c0, c1, c2, c3, c4 = (cs * v for v in _SIN_C)
    x4 = x2 * x2
    c = _fma64(x4 * x2, _fma64(x2, c4, c3),
               _fma64(x4, c2, _fma64(x2, c1, c0)))
    out = torch.where((n & 1) == 1, c, s).float()
    out = torch.where(top < 0x398, y, out)      # |y| < 2**-12: y itself
    return torch.where(top < 0x7F8, out, y - y)


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
                      shape: Union[int, Sequence[int]] = (),
                      offset: int = 0) -> torch.Tensor:
    """``erf_inv(u)``: the draws of ``normal`` before their factor √2
    (XLA folds that factor into a following constant multiply)."""
    return erf_inv(uniform(key, shape, _NORMAL_LO, 1.0, offset))


def normal(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``√2 · erf_inv(u)``; ``offset``
    as ``bits``."""
    return normal_over_sqrt2(key, shape, offset) * SQRT2_F32
