"""K1, the scheduling pass, as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/policy_eval.py::_pass_kernel`` (the Pallas TPU
kernel).  The CUDA source is ``repro_torch/csrc/policy_eval.cu``; it is
built with ``nvcc`` at first use and called through ctypes
(``kernels/build.py``).  Its plain PyTorch version is
``core.backfill.schedule_pass_batched``, in the same call signature.

``policy_eval_pass_batched`` takes tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.backfill import schedule_pass_batched
from repro_torch.kernels import build

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

#: The largest job-table capacity J the kernel takes (``kMaxJ`` in the
#: source: 29 bytes of shared memory per slot).
MAX_J = 4096

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("policy_eval")
        fn = lib.policy_eval_pass_batched
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.policy_eval_max_j.restype = ctypes.c_int
        if lib.policy_eval_max_j() != MAX_J:
            raise RuntimeError("policy_eval.cu and MAX_J disagree")
        _FN = fn
    return _FN


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def policy_eval_pass_batched(order: torch.Tensor, state: torch.Tensor,
                             nodes: torch.Tensor, est: torch.Tensor,
                             end_t: torch.Tensor, free0: torch.Tensor,
                             now: torch.Tensor,
                             limit: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy + EASY-backfill pass per fork.

    order, state, nodes (k, J) int32; est, end_t (k, J) float32; free0
    (k,) int32; now (k,) float32; limit an int32 tensor of one element
    (ranks at or past it hold no queued slot) or None for J.  Returns
    (started (k, J) bool, free (k,) int32)."""
    global LAUNCHES
    dev = order.device
    if dev.type == "cpu":
        return schedule_pass_batched(order, state, nodes, est, end_t,
                                     free0, now, limit)
    if dev.type != "cuda":
        raise ValueError(f"policy_eval_pass_batched: unsupported device "
                         f"{dev}")
    if order.ndim != 2:
        raise ValueError(f"order must be (k, J), got {tuple(order.shape)}")
    k, J = order.shape
    if J > MAX_J:
        raise ValueError(f"job table of {J} slots exceeds the kernel's "
                         f"MAX_J={MAX_J}")
    i32, f32 = torch.int32, torch.float32
    _check("order", order, i32, (k, J), dev)
    _check("state", state, i32, (k, J), dev)
    _check("nodes", nodes, i32, (k, J), dev)
    _check("est", est, f32, (k, J), dev)
    _check("end_t", end_t, f32, (k, J), dev)
    _check("free0", free0, i32, (k,), dev)
    _check("now", now, f32, (k,), dev)
    if limit is not None:
        _check("limit", limit, i32, (1,), dev)
    fn = _kernel()
    started = torch.empty((k, J), dtype=torch.bool, device=dev)
    free = torch.empty((k,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(order.data_ptr(), state.data_ptr(), nodes.data_ptr(),
                 est.data_ptr(), end_t.data_ptr(), free0.data_ptr(),
                 now.data_ptr(),
                 limit.data_ptr() if limit is not None else None,
                 started.data_ptr(), free.data_ptr(), k, J, stream)
    if err != 0:
        raise RuntimeError(f"policy_eval kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return started, free
