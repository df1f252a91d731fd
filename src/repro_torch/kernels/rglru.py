"""K2, the RG-LRU scan, as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/rglru.py::_rglru_kernel`` (the Pallas TPU
kernel).  The CUDA source is ``repro_torch/csrc/rglru.cu``, built with
``nvcc`` at first use and called through ctypes (``kernels/build.py``).
Its plain PyTorch version is ``models.blocks_rnn.rglru_scan``.

``rglru`` takes tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.

It keeps the Pallas entry's order of outputs, ``(h_all, h_final)``;
``rglru_scan`` returns ``(h_final, h_all)``, as the reference's does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models import blocks_rnn

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("rglru").rglru_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rglru(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B, S, W) float32; h0: (B, W) float32.  Returns
    (h_all (B, S, W), h_final (B, W)), both float32, with
    ``h_t = a_t * h_{t-1} + x_t``."""
    global LAUNCHES
    dev = a.device
    if dev.type == "cpu":
        h_final, h_all = blocks_rnn.rglru_scan(a, x, h0)
        return h_all, h_final
    if dev.type != "cuda":
        raise ValueError(f"rglru: unsupported device {dev}")
    if a.ndim != 3:
        raise ValueError(f"rglru: a must be (B, S, W), got "
                         f"{tuple(a.shape)}")
    b, s, w = a.shape
    for name, t, shape in (("x", x, a.shape), ("h0", h0, (b, w))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"rglru: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru: {name} has dtype {t.dtype}, expected "
                            f"float32")
        if t.device != dev:
            raise ValueError(f"rglru: {name} is on {t.device}, expected "
                             f"{dev}")
    if b == 0 or s == 0 or w == 0:
        raise ValueError(f"rglru: empty input {tuple(a.shape)}")
    a, x, h0 = a.contiguous(), x.contiguous(), h0.contiguous()
    h_all = torch.empty((b, s, w), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, w), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                 h_all.data_ptr(), h_final.data_ptr(), b, s, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return h_all, h_final
