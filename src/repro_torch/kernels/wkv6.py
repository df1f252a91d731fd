"""K3, the RWKV6 WKV recurrence, as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/wkv6.py::_wkv_kernel`` (the Pallas TPU kernel).
The CUDA source is ``repro_torch/csrc/wkv6.cu``, built with ``nvcc`` at
first use and called through ctypes (``kernels/build.py``).  Its plain
PyTorch version is ``models.blocks_rnn.wkv_scan`` from a zero state.

``wkv6`` takes tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.models import blocks_rnn

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

HEAD_SIZES = (16, 32, 64)

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("wkv6").wkv6_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the kernel
    copies 16 bytes at a time), copied only if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, S, H, N) float32; u: (H, N) float32.  From a zero
    state, returns (y (B, S, H, N), final state (B, H, N, N)), both
    float32, the state laid out [key i x value j]."""
    global LAUNCHES
    refuse_autograd("wkv6", r, k, v, w, u)
    dev = r.device
    if dev.type == "cpu":
        b, _, h, n = r.shape
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32)
        state, y = blocks_rnn.wkv_scan(state0, r, k, v, w, u)
        return y, state
    if dev.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {dev}")
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, N), got "
                         f"{tuple(r.shape)}")
    b, s, h, n = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (h, n))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {n} not in {HEAD_SIZES}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} has dtype {t.dtype}, expected "
                            f"float32")
        if t.device != dev:
            raise ValueError(f"wkv6: {name} is on {t.device}, expected "
                             f"{dev}")
    r, k, v, w, u = (_aligned(t) for t in (r, k, v, w, u))
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state
