"""The drain's step as one hand-written CUDA kernel for Hopper: after
K1's pass, each fork's starts, its advance to its next predicted end and
the next iteration's rank limit, in one launch.

It replaces no Pallas kernel (the JAX package runs these ops inside its
``lax.while_loop``, where XLA fuses them): it stands in for the ~50
PyTorch ops an iteration of its plain version, ``drain_step_plain``, the
``reference`` backend's step entry (``core/engine.py``'s ``BACKENDS``),
whose results it gives bit for bit.  The CUDA source is
``repro_torch/csrc/drain_step.cu``, built with ``nvcc`` at first use and
called through ctypes (``kernels/build.py``); the note at its top says
what bounds it.

Both entries update their arguments in place, on the drain loop's own
copy of the state (``des.simulate_to_drain_batched``):

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import des
from repro_torch.core.state import QUEUED, SimState
from repro_torch.kernels import build, check_arg

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

#: The largest job-table capacity J the kernel takes (``kMaxJ`` in the
#: source: eight slots a thread, at most 512 threads a fork).
MAX_J = 4096

_FNS = {}


def _kernel():
    if "drain_step" not in _FNS:
        lib = build.load("drain_step")
        fn = lib.drain_step
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.drain_step_max_j.restype = ctypes.c_int
        if lib.drain_step_max_j() != MAX_J:
            raise RuntimeError("drain_step.cu and MAX_J disagree")
        _FNS["drain_step"] = fn
    return _FNS["drain_step"]


def drain_step_plain(st: SimState, started: torch.Tensor,
                     active: torch.Tensor, dead: torch.Tensor,
                     iters: torch.Tensor, limit: torch.Tensor) -> None:
    """Plain version of the kernel (arguments as ``drain_step``): the
    drain's ops in their order, ``des.apply_starts``, ``des._advance``,
    the iteration count, the next ``active`` and ``des.pass_rank_limit``,
    each result copied into its argument."""
    started &= active[:, None]
    new = des.apply_starts(st, started)
    new, new_dead = des._advance(new, active, dead)
    iters += active.to(torch.int32)
    jobs, out = st.jobs, new.jobs
    jobs.start_t.copy_(out.start_t)
    jobs.end_t.copy_(out.end_t)
    jobs.state.copy_(out.state)
    st.free_nodes.copy_(new.free_nodes)
    st.now.copy_(new.now)
    dead.copy_(new_dead)
    active.copy_(~dead & (jobs.state == QUEUED).any(1))
    limit.copy_(des.pass_rank_limit(st, active))


def drain_step(st: SimState, started: torch.Tensor, active: torch.Tensor,
               dead: torch.Tensor, iters: torch.Tensor,
               limit: torch.Tensor) -> None:
    """One drain iteration after the pass, in place.

    st, a batched ``SimState`` of k forks and J slots, whose ``start_t``,
    ``end_t``, ``state``, ``free_nodes`` and ``now`` are updated; started
    (k, J) bool, the pass's starts, masked with ``active`` in place;
    active, dead (k,) bool and iters (k,) int32, the loop's per-fork
    flags and count; limit an int32 tensor of one element, the next
    iteration's rank limit.  ``active`` must be ``~dead`` and some slot
    QUEUED, as the loop keeps it."""
    global LAUNCHES
    dev = started.device
    if dev.type == "cpu":
        return drain_step_plain(st, started, active, dead, iters, limit)
    if dev.type != "cuda":
        raise ValueError(f"drain_step: unsupported device {dev}")
    if started.ndim != 2:
        raise ValueError(f"started must be (k, J), got "
                         f"{tuple(started.shape)}")
    k, J = started.shape
    if J > MAX_J:
        raise ValueError(f"job table of {J} slots exceeds the kernel's "
                         f"MAX_J={MAX_J}")
    jobs = st.jobs
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    check_arg("started", started, b8, (k, J), dev)
    check_arg("state", jobs.state, i32, (k, J), dev)
    check_arg("nodes", jobs.nodes, i32, (k, J), dev)
    check_arg("est", jobs.est_runtime, f32, (k, J), dev)
    check_arg("start_t", jobs.start_t, f32, (k, J), dev)
    check_arg("end_t", jobs.end_t, f32, (k, J), dev)
    check_arg("free_nodes", st.free_nodes, i32, (k,), dev)
    check_arg("now", st.now, f32, (k,), dev)
    check_arg("active", active, b8, (k,), dev)
    check_arg("dead", dead, b8, (k,), dev)
    check_arg("iters", iters, i32, (k,), dev)
    check_arg("limit", limit, i32, (1,), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            started.data_ptr(), jobs.state.data_ptr(), jobs.nodes.data_ptr(),
            jobs.est_runtime.data_ptr(), jobs.start_t.data_ptr(),
            jobs.end_t.data_ptr(), st.free_nodes.data_ptr(),
            st.now.data_ptr(), active.data_ptr(), dead.data_ptr(),
            iters.data_ptr(), limit.data_ptr(), k, J, stream)
    if err != 0:
        raise RuntimeError(f"drain_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
