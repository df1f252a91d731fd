"""Carry state, pools and model weights between the JAX package and the
port as numpy.

The twin's inputs are a job table and a policy pool.  A test makes them
once with numpy (or takes a JAX ``SimState`` through ``np.asarray``) and
hands the same arrays to both packages:

    d = {"jobs.submit_t": ..., ..., "jobs.state": ...,
         "free_nodes": ..., "total_nodes": ..., "now": ...}
    state = state_from_numpy(d, device="cpu")

numpy arrives as float64/int64; everything is cast to the reference's
dtypes on entry (times f32, node counts and lifecycle codes i32).

The LM's weights travel as the reference's flat parameter dict,
``{name: float32 ndarray}`` with its names and stacked shapes
(``embed``, ``final_norm.scale``, ``seg0.attn.wq`` of shape
(L, d, H, D)): ``params_from_numpy`` builds the port's ``LM`` from it and
``params_to_numpy`` is its inverse.  float32 carries bf16 exactly (the
machine with the card has no numpy bfloat16), so a test hands JAX's bf16
leaves over as ``np.asarray(x.astype(jnp.float32))``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policies import (N_THETA, PolicyPool, PolicySpec,
                                       describe_spec)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import JobTable, SimState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import LM

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


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, d: Dict[str, np.ndarray],
                      device: DeviceLike = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> LM:
    """The port's ``LM`` holding the values of ``d``, the reference's
    parameter dict (every name of ``api.param_table(cfg)``, float32),
    cast to ``dtype`` on ``device``."""
    model = LM(cfg, dtype, resolve_device(device))
    names = set()
    for name, shape, tensors in model.table_entries():
        if name not in d:
            raise KeyError(f"parameter dict lacks {name!r}")
        arr = np.array(d[name], dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(shape)}")
        if len(tensors) == 1 and tensors[0].shape == arr.shape:
            tensors[0].copy_(torch.from_numpy(arr))
        else:
            for j, t in enumerate(tensors):
                t.copy_(torch.from_numpy(arr[j]))
        names.add(name)
    extra = sorted(set(d) - names)
    if extra:
        raise KeyError(f"parameter dict has unknown names {extra}")
    return model


@torch.no_grad()
def params_to_numpy(model: LM) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: the reference's flat dict of
    float32 host arrays, scanned segments stacked on a leading axis."""
    out = {}
    for name, shape, tensors in model.table_entries():
        arr = torch.stack([t.float().cpu() for t in tensors]).numpy()
        out[name] = arr.reshape(shape)
    return out
