"""K2, the RG-LRU scan, as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/rglru.py::_rglru_kernel`` (the Pallas TPU
kernel).  The CUDA source is ``repro_torch/csrc/rglru.cu``, built with
``nvcc`` at first use and called through ctypes (``kernels/build.py``).
It has two entries, one kernel and one chain:

  * ``rglru(a, x, h0)``, the Pallas entry's counterpart; its plain
    PyTorch version is ``models.blocks_rnn.rglru_scan``;
  * ``rglru_gated(...)``, recurrentgemma's RG-LRU layer between its
    matrix products, gates formed in the kernel's load stage and the
    branch product in its store stage; its plain version is
    ``models.blocks_rnn.rglru_gated_scan``.

Both take tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch of either entry adds one to ``LAUNCHES``.  A failed build or
    launch raises: nothing falls back to the plain version.

``rglru`` keeps the Pallas entry's order of outputs, ``(h_all,
h_final)``; ``rglru_scan`` returns ``(h_final, h_all)``, as the
reference's does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.models import blocks_rnn

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def _kernel(entry: str):
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(build.load("rglru"), entry)
        n_ptr = 5 if entry == "rglru_fwd" else 10
        n_int = 4 if entry == "rglru_fwd" else 5
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def plan(width: int, itemsize: int, ptrs: Sequence[int]) -> bool:
    """The kernel's load and store path: True for TMA, which needs every
    row of every (B, S, W) array (``ptrs``, their base addresses) to
    start on a 16-byte boundary; False for one element a thread at a
    time (a ragged W, a misaligned view)."""
    return (width * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def _check(entry: str, named, dtype, dev) -> None:
    """Raise unless every ``(name, tensor, shape)`` has that shape, dtype
    and device."""
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{entry}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{entry}: {name} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if t.device != dev:
            raise ValueError(f"{entry}: {name} is on {t.device}, expected "
                             f"{dev}")


def _launch(fn, args) -> None:
    global LAUNCHES
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def rglru(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B, S, W) float32; h0: (B, W) float32.  Returns
    (h_all (B, S, W), h_final (B, W)), both float32, with
    ``h_t = a_t * h_{t-1} + x_t``."""
    refuse_autograd("rglru", a, x, h0)
    dev = a.device
    if dev.type == "cpu":
        h_final, h_all = blocks_rnn.rglru_scan(a, x, h0)
        return h_all, h_final
    if dev.type != "cuda":
        raise ValueError(f"rglru: unsupported device {dev}")
    if a.ndim != 3:
        raise ValueError(f"rglru: a must be (B, S, W), got "
                         f"{tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"rglru: a has dtype {a.dtype}, expected float32")
    b, s, w = a.shape
    _check("rglru", (("x", x, a.shape), ("h0", h0, (b, w))), torch.float32,
           dev)
    if b == 0 or s == 0 or w == 0:
        raise ValueError(f"rglru: empty input {tuple(a.shape)}")
    a, x, h0 = a.contiguous(), x.contiguous(), h0.contiguous()
    h_all = torch.empty((b, s, w), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, w), dtype=torch.float32, device=dev)
    tma = plan(w, 4, [t.data_ptr() for t in (a, x, h_all)])
    with torch.cuda.device(dev):
        _launch(_kernel("rglru_fwd"),
                (a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                 h_all.data_ptr(), h_final.data_ptr(), b, s, w, int(tma)))
    return h_all, h_final


def rglru_gated(gr: torch.Tensor, gi: torch.Tensor, u: torch.Tensor,
                branch: torch.Tensor, rgate_bias: torch.Tensor,
                igate_bias: torch.Tensor, lam: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                h_final: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """recurrentgemma's RG-LRU between its matrix products, as
    ``blocks_rnn.rglru_gated_scan`` computes it.  gr, gi (the gate
    products ``u @ w_rgate``, ``u @ w_igate``, no bias), u (after the
    conv), branch (after its GeLU): (B, S, W); rgate_bias, igate_bias,
    lam: (W,); all float32 or all bfloat16.  h0: (B, W) float32, or None
    for zeros.  Returns ``(branch * h, h_final)``: (B, S, W) in the
    inputs' dtype and (B, W) float32.  ``h_final``, when given, is a
    (B, W) float32 tensor written in place and returned; it may be
    ``h0`` itself (decode updates the cache's h so)."""
    refuse_autograd("rglru_gated", gr, gi, u, branch, rgate_bias,
                    igate_bias, lam, h0)
    dev = gr.device
    if dev.type == "cpu":
        y, hf = blocks_rnn.rglru_gated_scan(gr, gi, u, branch, rgate_bias,
                                            igate_bias, lam, h0)
        if h_final is not None:
            hf = h_final.copy_(hf)
        return y, hf
    if dev.type != "cuda":
        raise ValueError(f"rglru_gated: unsupported device {dev}")
    if gr.ndim != 3:
        raise ValueError(f"rglru_gated: gr must be (B, S, W), got "
                         f"{tuple(gr.shape)}")
    b, s, w = gr.shape
    if gr.dtype not in _DTYPES:
        raise TypeError(f"rglru_gated: dtype {gr.dtype}; expected one of "
                        f"float32, bfloat16")
    _check("rglru_gated", (("gi", gi, gr.shape), ("u", u, gr.shape),
                           ("branch", branch, gr.shape),
                           ("rgate_bias", rgate_bias, (w,)),
                           ("igate_bias", igate_bias, (w,)),
                           ("lam", lam, (w,))), gr.dtype, dev)
    if h_final is None:
        h_final = torch.empty((b, w), dtype=torch.float32, device=dev)
    _check("rglru_gated", [("h_final", h_final, (b, w))]
           + ([] if h0 is None else [("h0", h0, (b, w))]), torch.float32,
           dev)
    if not h_final.is_contiguous():
        raise ValueError("rglru_gated: h_final must be contiguous")
    if b == 0 or s == 0 or w == 0:
        raise ValueError(f"rglru_gated: empty input {tuple(gr.shape)}")
    gr, gi, u, branch, rgate_bias, igate_bias, lam = (
        t.contiguous() for t in (gr, gi, u, branch, rgate_bias, igate_bias,
                                 lam))
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty((b, s, w), dtype=gr.dtype, device=dev)
    tma = plan(w, gr.element_size(),
               [t.data_ptr() for t in (gr, gi, u, branch, y)])
    with torch.cuda.device(dev):
        _launch(_kernel("rglru_gated_fwd"),
                (gr.data_ptr(), gi.data_ptr(), u.data_ptr(),
                 branch.data_ptr(), rgate_bias.data_ptr(),
                 igate_bias.data_ptr(), lam.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_final.data_ptr(), b, s, w, _DTYPES[gr.dtype], int(tma)))
    return y, h_final
