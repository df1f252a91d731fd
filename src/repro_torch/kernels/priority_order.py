"""The order stage of the drain and the replay as one hand-written CUDA
kernel for Hopper: each fork's priority keys, its stable sort and the
queued-first compaction of hoisted forks, in one launch, in fork order.

It replaces no Pallas kernel (the JAX package leaves the stage to XLA):
it stands in for the ~80 PyTorch ops a step of its plain version,
``priority_order_plain``, the ``reference`` backend's order entry
(``core/engine.py``'s ``BACKENDS``), whose output it gives element for
element.  The CUDA source is ``repro_torch/csrc/priority_order.cu``,
built with ``nvcc`` at first use and called through ctypes
(``kernels/build.py``); the note at its top says what bounds it.

``priority_order`` takes tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.

A pool reaches the kernel as rows (``pool_rows``): a ``PolicySpec``'s
family and θ as they are, integer ids lifted to their ``static_spec``
rows.  Their keys are the id stack's (``policies.priority_key``), except
EXPF's on the card, where the id stack divides by the host scalar 3600
and torch multiplies by its reciprocal instead: that row takes the
family code ``FAM_EXPF_ID``, which ages by the same product.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.core.backfill import compact_queued_first
from repro_torch.core.policies import PolicySpec
from repro_torch.core.state import QUEUED, JobTable
from repro_torch.device import upload
from repro_torch.kernels import build, check_arg

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

#: The largest job-table capacity J the kernel takes (``kMaxJ`` in the
#: source: its shared memory, 9 bytes a slot and a warp).
MAX_J = 4096

#: The family code of the integer-id EXPF row: the EXP family aged by
#: ``wait · (1/τ)``, as the id stack's ``wait / 3600.0`` runs on the card.
FAM_EXPF_ID = 3

_FNS = {}


def _kernel(entry: str):
    """The C entry ``entry`` of the library: ``priority_order`` or
    ``priority_keys``."""
    if entry not in _FNS:
        lib = build.load("priority_order")
        fn = getattr(lib, entry)
        n_ptr = 10 if entry == "priority_order" else 8
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.priority_order_max_j.restype = ctypes.c_int
        if lib.priority_order_max_j() != MAX_J:
            raise RuntimeError("priority_order.cu and MAX_J disagree")
        _FNS[entry] = fn
    return _FNS[entry]


def _id_rows() -> Tuple[np.ndarray, np.ndarray]:
    """(family, θ) of every integer policy id, by id."""
    ids = range(len(policies.POLICY_NAMES))
    family = np.array([int(policies.static_spec(i).family) for i in ids],
                      dtype=np.int32)
    family[policies.EXPF] = FAM_EXPF_ID
    theta = np.stack([policies.static_spec(i).theta.numpy() for i in ids])
    return family, theta


def pool_rows(pool, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pool's (family (k,) int32, θ (k, N_THETA) float32) on
    ``device``, contiguous: a ``PolicySpec``'s leaves, or the rows of
    integer ids, gathered on the device (no read of the ids)."""
    if isinstance(pool, PolicySpec):
        return (pool.family.to(device, torch.int32).contiguous(),
                pool.theta.to(device, torch.float32).contiguous())
    family, theta = _id_rows()
    ids = torch.as_tensor(pool).to(device).long()
    return (upload(family, device)[ids].contiguous(),
            upload(theta, device)[ids].contiguous())


def order_keys(jobs: JobTable, now: torch.Tensor, family: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """(k, J) keys of rows (family, θ): ``policies.priority_key_spec``,
    and the id stack's EXPF key where the family is ``FAM_EXPF_ID``."""
    keys = policies.priority_key_spec(jobs, now, PolicySpec(family, theta))
    id_expf = family == FAM_EXPF_ID
    if bool(id_expf.any()):
        keys = torch.where(id_expf[:, None],
                           policies.priority_key(jobs, now, policies.EXPF),
                           keys)
    return keys


def _jobs(state, submit, est, nodes) -> JobTable:
    return JobTable(submit_t=submit, nodes=nodes, est_runtime=est,
                    start_t=submit, end_t=submit, state=state)


def priority_order_plain(state: torch.Tensor, submit: torch.Tensor,
                         est: torch.Tensor, nodes: torch.Tensor,
                         now: torch.Tensor, family: torch.Tensor,
                         theta: torch.Tensor, hoisted: torch.Tensor,
                         hoist_row: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (inputs as ``priority_order``): the
    re-sorted forks' keys and stable argsort, the hoisted forks'
    compaction, each over its own forks, written in fork order."""
    k, J = state.shape
    queued = state == QUEUED
    out = torch.empty((k, J), dtype=torch.int32, device=state.device)
    resorted = hoist_row < 0
    tv = torch.nonzero(resorted)[:, 0]
    ti = torch.nonzero(~resorted)[:, 0]
    if tv.numel():
        keys = order_keys(_jobs(state[tv], submit[tv], est[tv], nodes[tv]),
                          now[tv], family[tv], theta[tv])
        keys = torch.where(queued[tv], keys, torch.inf)
        out[tv] = torch.argsort(keys, dim=-1, stable=True).to(torch.int32)
    if ti.numel():
        out[ti] = compact_queued_first(hoisted[hoist_row[ti].long()],
                                       queued[ti])
    return out


def _check_rows(state, submit, est, nodes, now, family, theta):
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"priority_order: unsupported device {dev}")
    if state.ndim != 2:
        raise ValueError(f"state must be (k, J), got {tuple(state.shape)}")
    k, J = state.shape
    if J > MAX_J:
        raise ValueError(f"job table of {J} slots exceeds the kernel's "
                         f"MAX_J={MAX_J}")
    i32, f32 = torch.int32, torch.float32
    check_arg("state", state, i32, (k, J), dev)
    check_arg("submit", submit, f32, (k, J), dev)
    check_arg("est", est, f32, (k, J), dev)
    check_arg("nodes", nodes, i32, (k, J), dev)
    check_arg("now", now, f32, (k,), dev)
    check_arg("family", family, i32, (k,), dev)
    check_arg("theta", theta, f32, (k, policies.N_THETA), dev)
    return k, J


def priority_order(state: torch.Tensor, submit: torch.Tensor,
                   est: torch.Tensor, nodes: torch.Tensor, now: torch.Tensor,
                   family: torch.Tensor, theta: torch.Tensor,
                   hoisted: torch.Tensor, hoist_row: torch.Tensor
                   ) -> torch.Tensor:
    """The (k, J) int32 priority order of every fork.

    state, nodes (k, J) int32; submit, est (k, J) float32 (the job
    table's fields); now (k,) float32; family (k,) int32 and theta
    (k, N_THETA) float32, the pool's rows (``pool_rows``); hoisted
    (n, J) int32, the static orders of the hoisted forks; hoist_row (k,)
    int32, each fork's row of ``hoisted``, or -1 for a fork that is
    re-sorted.  A re-sorted fork's order is the stable argsort of its
    keys (+inf where a slot is not queued); a hoisted fork's is its
    static row with the queued slots first."""
    global LAUNCHES
    if state.device.type == "cpu":
        return priority_order_plain(state, submit, est, nodes, now, family,
                                    theta, hoisted, hoist_row)
    k, J = _check_rows(state, submit, est, nodes, now, family, theta)
    dev = state.device
    check_arg("hoist_row", hoist_row, torch.int32, (k,), dev)
    check_arg("hoisted", hoisted, torch.int32, (hoisted.shape[0], J), dev)
    out = torch.empty((k, J), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel("priority_order")(
            state.data_ptr(), submit.data_ptr(), est.data_ptr(),
            nodes.data_ptr(), now.data_ptr(), family.data_ptr(),
            theta.data_ptr(), hoisted.data_ptr() if hoisted.numel() else None,
            hoist_row.data_ptr(), out.data_ptr(), k, J, stream)
    if err != 0:
        raise RuntimeError(f"priority_order kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def priority_keys(state: torch.Tensor, submit: torch.Tensor,
                  est: torch.Tensor, nodes: torch.Tensor, now: torch.Tensor,
                  family: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The kernel's (k, J) float32 keys, +inf where a slot is not queued
    (inputs as ``priority_order``): what the checks of C3 compare with
    torch's ops.  CPU tensors take ``order_keys``."""
    if state.device.type == "cpu":
        keys = order_keys(_jobs(state, submit, est, nodes), now, family,
                          theta)
        return torch.where(state == QUEUED, keys, torch.inf)
    k, J = _check_rows(state, submit, est, nodes, now, family, theta)
    dev = state.device
    keys = torch.empty((k, J), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel("priority_keys")(
            state.data_ptr(), submit.data_ptr(), est.data_ptr(),
            nodes.data_ptr(), now.data_ptr(), family.data_ptr(),
            theta.data_ptr(), keys.data_ptr(), k, J, stream)
    if err != 0:
        raise RuntimeError(f"priority_keys kernel launch failed: CUDA "
                           f"error {err}")
    return keys
