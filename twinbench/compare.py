"""The numbers that decide ``correct``: each reading beside its limit, and
the two ways a reading is taken (differing bits, relative gap)."""
from __future__ import annotations

import sys
from typing import List, NamedTuple

import numpy as np
import torch

BIG = sys.float_info.max    # how a non-finite reading is printed


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)   # NaN fails


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def bits_diff(a, b) -> int:
    """Elements of a and b whose bits differ (shapes must agree)."""
    a, b = _host(a), _host(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a = np.ascontiguousarray(a, np.float32).view(np.int32)
        b = np.ascontiguousarray(b, np.float32).view(np.int32)
    return int(np.count_nonzero(a != b))


def rel_gap(a, b) -> float:
    """max |a − b| / |b| over the elements (b the reference); equal
    values, infinities included, give 0; a value where the other is
    infinite or NaN gives infinity."""
    a = _host(a).astype(np.float64).ravel()
    b = _host(b).astype(np.float64).ravel()
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    gap = np.where(same, 0.0, np.where(np.isfinite(gap), gap, np.inf))
    return float(gap.max())


def printable(v: float) -> float:
    v = float(v)
    return v if np.isfinite(v) else BIG


def report(checks: List[Check]) -> dict:
    """The result line's last key: each reading with its limit."""
    return {c.name: {"value": printable(c.value), "limit": c.limit}
            for c in checks}
