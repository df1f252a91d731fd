"""Per-family search spaces: free search coordinates ↔ full θ — port of
``repro/learn/evolution.py`` (the same boxes, ``x0``, ``sigma0``, clip
and decode, bitwise).

The trainer searches a small unconstrained space z (the family's free
parameters, timescales in log10) and decodes each candidate into a
full (N_THETA,) θ row for ``policies.theta_pool``.  Bounds are clipped
at decode time, so every strategy proposal is a valid policy and the
decode is a pure deterministic function — bitwise-stable across
resume.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.core import policies
from repro_torch.core.policies import (EXTENDED_POOL, FAM_EXP, FAM_LIN, FAM_WFP,
                                 N_FEATURES, N_THETA, POLICY_NAMES, TH_A,
                                 TH_B, TH_TAU)


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Free-dim search space for one policy family.

    ``idx[d]`` is the θ slot dim d writes; ``log10[d]`` dims decode as
    10**z (timescales); z is clipped to [lo, hi] before decoding.
    ``x0``/``sigma0`` are the default initial mean/scale in z-space.
    """

    family: int
    names: Tuple[str, ...]
    idx: Tuple[int, ...]
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    log10: Tuple[bool, ...]
    x0: Tuple[float, ...]
    sigma0: Tuple[float, ...]

    @property
    def dim(self) -> int:
        return len(self.names)

    def clip(self, z: np.ndarray) -> np.ndarray:
        z = np.asarray(z, np.float32)
        return np.clip(z, np.asarray(self.lo, np.float32),
                       np.asarray(self.hi, np.float32))

    def decode(self, z: np.ndarray) -> np.ndarray:
        """(N, dim) search points -> (N, N_THETA) full θ rows."""
        z = self.clip(np.atleast_2d(z))
        if z.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}), got {z.shape}")
        th = np.tile(policies._base_theta(), (z.shape[0], 1))
        for d, slot in enumerate(self.idx):
            col = z[:, d]
            th[:, slot] = np.power(np.float32(10.0), col) if self.log10[d] else col
        return th.astype(np.float32)


_LIN_SPACE = ParamSpace(
    family=FAM_LIN,
    names=policies.FEATURES,
    idx=tuple(range(N_FEATURES)),
    lo=(-3.0,) * N_FEATURES,
    hi=(3.0,) * N_FEATURES,
    log10=(False,) * N_FEATURES,
    x0=(0.0,) * N_FEATURES,
    sigma0=(0.5,) * N_FEATURES,
)

# wfp: exponents (a, b) direct; τ searched as log10 (τ=10^z, z∈[1,7]
# spans 10 s .. 10^7 s — z=7 is effectively aging-off on trace scales).
_WFP_SPACE = ParamSpace(
    family=FAM_WFP,
    names=("a", "b", "log10_tau"),
    idx=(TH_A, TH_B, TH_TAU),
    lo=(0.0, -2.0, 1.0),
    hi=(8.0, 4.0, 7.0),
    log10=(False, False, True),
    x0=(3.0, 1.0, 6.0),
    sigma0=(1.0, 0.5, 1.0),
)

_EXP_SPACE = ParamSpace(
    family=FAM_EXP,
    names=("log10_tau",),
    idx=(TH_TAU,),
    lo=(1.0,),
    hi=(7.0,),
    log10=(True,),
    x0=(math.log10(3600.0),),
    sigma0=(0.5,),
)

_SPACES = {FAM_LIN: _LIN_SPACE, FAM_WFP: _WFP_SPACE, FAM_EXP: _EXP_SPACE}


def family_space(family) -> ParamSpace:
    """The search space of a family (id or name: "lin"/"wfp"/"expf")."""
    if isinstance(family, str):
        try:
            family = policies._FAMILY_BY_NAME[family.strip().lower()]
        except KeyError:
            raise ValueError(
                f"unknown family {family!r}; have "
                f"{sorted(policies._FAMILY_BY_NAME)}") from None
    return _SPACES[int(family)]


def static_seeds(family: int) -> List[Tuple[str, np.ndarray]]:
    """The static fixed points representable in ``family``, as
    (name, full θ) warm-start rows — gen-0 candidates that guarantee
    the search starts no worse than the classical baselines.

    Note WFP's fixed point (τ=∞) and FCFS/SAF's unbounded submit/area
    weights sit OUTSIDE the clipped search box — they are injected as
    exact θ rows precisely because the box cannot express them.
    """
    out: List[Tuple[str, np.ndarray]] = []
    for pid in EXTENDED_POOL:
        spec = policies.static_spec(pid)
        if int(spec.family) == int(family):
            out.append((POLICY_NAMES[pid],
                        spec.theta.numpy().astype(np.float32)))
    return out
