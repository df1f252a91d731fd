"""K1 and K1', the scheduling pass, as a hand-written CUDA kernel for
Hopper.

Replaces ``repro/kernels/policy_eval.py::_pass_kernel`` (the Pallas TPU
kernel) through both of its entries: ``policy_eval_pass_batched`` (K1,
every input carries the fork axis) and ``policy_eval_pass`` (K1', k
orders over one shared (J,) snapshot).  The CUDA source is
``repro_torch/csrc/policy_eval.cu``; it is built with ``nvcc`` at first
use and called through ctypes (``kernels/build.py``).  The plain PyTorch
version of both is ``core.backfill.schedule_pass_batched`` (for K1', on
the shared rows expanded to k).

Both entries take tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES`` (K1) or ``SHARED_LAUNCHES`` (K1').
    A failed build or launch raises: nothing falls back to the plain
    version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.backfill import schedule_pass_batched
from repro_torch.kernels import build, check_arg

#: Kernel launches since the last reset (``LAUNCHES = 0``): K1, then K1'.
LAUNCHES = 0
SHARED_LAUNCHES = 0

#: The largest job-table capacity J the kernel takes (``kMaxJ`` in the
#: source: 25 bytes of shared memory per slot).
MAX_J = 4096

_FNS = {}


def _kernel(entry: str = "policy_eval_pass_batched"):
    """The C entry ``entry`` of the library: ``policy_eval_pass_batched``
    (K1) or ``policy_eval_pass`` (K1'), which share one signature."""
    if entry not in _FNS:
        lib = build.load("policy_eval")
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.policy_eval_max_j.restype = ctypes.c_int
        if lib.policy_eval_max_j() != MAX_J:
            raise RuntimeError("policy_eval.cu and MAX_J disagree")
        _FNS[entry] = fn
    return _FNS[entry]


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
    check_arg("order", order, i32, (k, J), dev)
    check_arg("state", state, i32, (k, J), dev)
    check_arg("nodes", nodes, i32, (k, J), dev)
    check_arg("est", est, f32, (k, J), dev)
    check_arg("end_t", end_t, f32, (k, J), dev)
    check_arg("free0", free0, i32, (k,), dev)
    check_arg("now", now, f32, (k,), dev)
    if limit is not None:
        check_arg("limit", limit, i32, (1,), dev)
    started, free = _launch("policy_eval_pass_batched", order, state,
                            nodes, est, end_t, free0, now, limit)
    LAUNCHES += 1
    return started, free


def _launch(entry, order, state, nodes, est, end_t, free0, now, limit):
    k, J = order.shape
    dev = order.device
    fn = _kernel(entry)
    started = torch.empty((k, J), dtype=torch.bool, device=dev)
    free = torch.empty((k,), dtype=torch.int32, device=dev)
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
    return started, free


def policy_eval_pass(order: torch.Tensor, state: torch.Tensor,
                     nodes: torch.Tensor, est: torch.Tensor,
                     end_t: torch.Tensor, free0: torch.Tensor,
                     now: torch.Tensor, limit: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy + EASY-backfill pass for each of k orders over ONE
    shared snapshot (K1', the first pass of a decision cycle, where the
    forks still share one queue state).

    order (k, J) int32; state, nodes (J,) int32; est, end_t (J,)
    float32; free0 an int32 and now a float32 tensor of one element;
    limit as ``policy_eval_pass_batched``.  Returns (started (k, J)
    bool, free (k,) int32)."""
    global SHARED_LAUNCHES
    dev = order.device
    if order.ndim != 2:
        raise ValueError(f"order must be (k, J), got {tuple(order.shape)}")
    k, J = order.shape
    if dev.type == "cpu":
        return shared_pass_plain(order, state, nodes, est, end_t, free0,
                                 now, limit)
    if dev.type != "cuda":
        raise ValueError(f"policy_eval_pass: unsupported device {dev}")
    if J > MAX_J:
        raise ValueError(f"job table of {J} slots exceeds the kernel's "
                         f"MAX_J={MAX_J}")
    i32, f32 = torch.int32, torch.float32
    check_arg("order", order, i32, (k, J), dev)
    check_arg("state", state, i32, (J,), dev)
    check_arg("nodes", nodes, i32, (J,), dev)
    check_arg("est", est, f32, (J,), dev)
    check_arg("end_t", end_t, f32, (J,), dev)
    free0, now = free0.reshape(1), now.reshape(1)
    check_arg("free0", free0, i32, (1,), dev)
    check_arg("now", now, f32, (1,), dev)
    if limit is not None:
        check_arg("limit", limit, i32, (1,), dev)
    started, free = _launch("policy_eval_pass", order, state, nodes, est,
                            end_t, free0, now, limit)
    SHARED_LAUNCHES += 1
    return started, free


def shared_pass_plain(order: torch.Tensor, state: torch.Tensor,
                      nodes: torch.Tensor, est: torch.Tensor,
                      end_t: torch.Tensor, free0: torch.Tensor,
                      now: torch.Tensor, limit: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1' (inputs as ``policy_eval_pass``): the batched
    pass on the shared rows expanded, without a copy, to the k forks."""
    k, J = order.shape
    rows = lambda t: t.reshape(1, J).expand(k, J)           # noqa: E731
    return schedule_pass_batched(
        order, rows(state), rows(nodes), rows(est), rows(end_t),
        free0.reshape(1).expand(k), now.reshape(1).expand(k), limit)
