"""Carry state and pools between the JAX package and the port as numpy.

The port has no weights; its inputs are a job table and a policy pool.
A test makes them once with numpy (or takes a JAX ``SimState`` through
``np.asarray``) and hands the same arrays to both packages:

    d = {"jobs.submit_t": ..., ..., "jobs.state": ...,
         "free_nodes": ..., "total_nodes": ..., "now": ...}
    state = state_from_numpy(d, device="cpu")

numpy arrives as float64/int64; everything is cast to the reference's
dtypes on entry (times f32, node counts and lifecycle codes i32).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policies import (N_THETA, PolicyPool, PolicySpec,
                                       describe_spec)
from repro_torch.core.state import JobTable, SimState
from repro_torch.device import DeviceLike, resolve_device

JOB_FIELDS = JobTable._fields
_I32_JOB_FIELDS = ("nodes", "state")
STATE_KEYS = tuple(f"jobs.{f}" for f in JOB_FIELDS) + (
    "free_nodes", "total_nodes", "now")


def state_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = "cuda") -> SimState:
    """A ``SimState`` from the dict of ``STATE_KEYS`` (unbatched (J,)
    job fields or batched (k, J), scalars () or (k,))."""
    dev = resolve_device(device)
    missing = [key for key in STATE_KEYS if key not in d]
    if missing:
        raise KeyError(f"state dict lacks {missing}")

    def tensor(value, dtype) -> torch.Tensor:
        np_dtype = np.int32 if dtype == torch.int32 else np.float32
        return torch.from_numpy(
            np.array(value, dtype=np_dtype, order="C")).to(dev)

    jobs = JobTable(*(tensor(d[f"jobs.{f}"], torch.int32
                             if f in _I32_JOB_FIELDS else torch.float32)
                      for f in JOB_FIELDS))
    return SimState(jobs=jobs,
                    free_nodes=tensor(d["free_nodes"], torch.int32),
                    total_nodes=tensor(d["total_nodes"], torch.int32),
                    now=tensor(d["now"], torch.float32))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``: host numpy copies of every
    leaf.  Takes any state with the ``SimState`` layout whose leaves
    ``np.asarray`` understands (the reference's included)."""
    out = {f"jobs.{f}": _host(getattr(state.jobs, f)) for f in JOB_FIELDS}
    out.update(free_nodes=_host(state.free_nodes),
               total_nodes=_host(state.total_nodes),
               now=_host(state.now))
    return out


def pool_from_numpy(family: np.ndarray, theta: np.ndarray,
                    names: Optional[Sequence[str]] = None,
                    device: DeviceLike = "cuda") -> PolicyPool:
    """A ``PolicyPool`` from (k,) family codes and (k, N_THETA) θ rows."""
    dev = resolve_device(device)
    fam = np.array(family, dtype=np.int32).reshape(-1)
    th = np.array(theta, dtype=np.float32).reshape(fam.shape[0], N_THETA)
    if names is None:
        names = [describe_spec(fam[i], th[i]) for i in range(fam.shape[0])]
    spec = PolicySpec(torch.from_numpy(fam).to(dev),
                      torch.from_numpy(th).to(dev))
    return PolicyPool(spec=spec, names=tuple(names))
