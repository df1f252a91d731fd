"""The fan's member draws: threefry2x32 keys and draws, the f32 elementary
functions they need, and the two perturbations a decision fan applies.

A frozen copy of the semantics ``jax.random`` (threefry2x32, partitionable)
and XLA's f32 ``erf_inv``/``log1p``/``exp`` give, built from IEEE-exact
torch operations so that every device returns the same bits.  Member
``phi`` of scenario ``s`` under ``seed`` draws from the key chain
``fold_in(fold_in(fold_in(PRNGKey(seed), s), phi), tag)``: tag 0 holds
the runtime-noise normals, tag 2 the two failure uniforms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x0, x1):
    """20 rounds of threefry2x32 on int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """One key per element of ``data`` (an int or an integer tensor
    broadcast against the key's leading axes)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    k1, k2 = key[..., 0], key[..., 1]
    shape = torch.broadcast_shapes(k1.shape, d.shape)
    y0, y1 = threefry_2x32(k1, k2, torch.zeros(shape, dtype=torch.int64,
                                               device=key.device), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def _bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits (int64 in [0, 2**32)) for each of ``n`` counters
    under each leading key: ``hi ^ lo`` of threefry over the 64-bit iota."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry_2x32(k1, k2, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(lead + (n,))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of f32 operands rounded once to f32 (the exact f32
    product plus an f64 add, then one rounding)."""
    tensors = [v for v in (a, b, c) if isinstance(v, torch.Tensor)]
    dev = tensors[0].device
    shape = torch.broadcast_shapes(*(v.shape for v in tensors))
    ops = [v.double() if isinstance(v, torch.Tensor)
           else torch.full((1,), float(np.float32(v)), dtype=torch.float64,
                           device=dev)
           for v in (a, b, c)]
    return torch.addcmul(ops[2], ops[0], ops[1]).float().reshape(shape)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def uniform(key: torch.Tensor, n: int, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """f32 uniforms on [lo, hi): 23 random mantissa bits under exponent 0,
    minus one, scaled with one fused multiply-add."""
    b = _bits(key, n)
    f = (((b >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=key.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=key.device)
    return torch.maximum(lo_t, _fma(f, hi_t - lo_t, lo_t))


_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes logf for positive normal f32 ``x``."""
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
    xs = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(_c(-0.5, x), xs, (x * xs) * r)
    big = log_f32(torch.clamp(x + 1.0, min=_c(1.17549435e-38, x)))
    return torch.where(x.abs() < _c(0.41421356237309504880, x), small, big)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root."""
    return torch.sqrt(x.double()).float()


_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes expf: ``x = a + n·ln 2``, a degree-5 polynomial in a."""
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


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 inverse error function (Giles' polynomial)."""
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


def member_draws(seed: int, s: torch.Tensor, phi: torch.Tensor, J: int):
    """For each (scenario, member) pair: the runtime-noise normals over
    sqrt(2), shape (B, J), and the two failure uniforms, shape (B, 2)."""
    key = fold_in(fold_in(prng_key(seed, s.device), s), phi)
    z = erf_inv(uniform(fold_in(key, 0), J, _NORMAL_LO, 1.0))
    u = uniform(fold_in(key, 2), 2)
    return z, u


def lognormal_scale(z: torch.Tensor, sigma: float) -> torch.Tensor:
    """The mean-preserving factor ``exp(sigma·eps − sigma²/2)`` of the
    normals ``eps = sqrt(2)·z``, as one fused multiply-add and expf."""
    k = float(np.float32(SQRT2_F32) * np.float32(sigma))
    return exp_f32(_fma(z, k, -(0.5 * sigma * sigma)))


def failure_downs(prob: float, frac: float, phi: torch.Tensor,
                  u: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Nodes each member loses: with probability ``prob`` (a uniform under
    it) a share ``u1·frac`` of the cluster, floored; member 0 none."""
    totf = total.to(torch.float32)
    hit = (u[:, 0] < prob) & (phi != 0)
    down = torch.where(hit, torch.floor(totf * (u[:, 1] * frac)),
                       torch.zeros_like(totf))
    return down.to(total.dtype)
