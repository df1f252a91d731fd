"""The device trace of a short steady window inside one unit of work.

The program launches K1 (``repro_torch.kernels.policy_eval``) once per
drain or replay iteration, so its Python entry marks iterations: the
window wraps that entry, starts ``torch.profiler`` at launch ``start``
(a warm-up step whose records are dropped), and records the ``active``
launches that follow ``warm`` more.  Both ends synchronize the device,
so the window's wall holds exactly its kernels.  The window copies the
job state and rank limit each of its K1 launches is given into buffers
set aside before the profiler starts (one device-to-device copy a launch,
no allocation inside the window) and counts, once it has closed, the
least bytes each launch needed (``roofline.k1_bytes``).
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from twinbench.reference.sim import QUEUED, RUNNING
from twinbench.roofline import k1_bytes

K1_KERNEL = "pass_kernel"


class K1Window:
    def __init__(self, start: int, warm: int, active: int) -> None:
        self.marks = (start, start + warm, start + warm + active)
        self.active = active
        self.calls = 0
        self.prof = None
        self.wall: Optional[float] = None
        self.events = None
        self.states = self.limits = None
        self.launch_bytes: List[int] = []

    def __enter__(self) -> "K1Window":
        from repro_torch.kernels import policy_eval
        self._mod = policy_eval
        self._orig = policy_eval.policy_eval_pass_batched

        def counted(*args, **kw):
            n = self.calls
            self._mark(n, args[1])
            self.calls += 1
            if self.marks[1] <= n < self.marks[2]:
                i = n - self.marks[1]
                limit = kw.get("limit", args[7] if len(args) > 7 else None)
                self.states[i].copy_(args[1])
                if limit is not None:
                    self.limits[i:i + 1].copy_(limit)
            return self._orig(*args, **kw)
        policy_eval.policy_eval_pass_batched = counted
        return self

    def _mark(self, n: int, state: torch.Tensor) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        first, begin, end = self.marks
        sync = torch.cuda.synchronize if state.is_cuda else (lambda: None)
        if n == first:
            self.states = state.new_empty((self.active,) + state.shape)
            self.limits = torch.full((self.active,), -1, dtype=torch.int32,
                                     device=state.device)
            self.prof = profile(
                activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if state.is_cuda else []),
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=self._ready)
            self.prof.start()
        elif n == begin and self.prof is not None:
            sync()
            self._t0 = time.perf_counter()
            self.prof.step()
        elif n == end and self.prof is not None:
            sync()
            self.wall = time.perf_counter() - self._t0
            self.prof.step()
            self.prof.stop()
            self.prof = None
            self._count_bytes()

    def _count_bytes(self) -> None:
        J = self.states.shape[-1]
        q = (self.states == QUEUED).sum(2).cpu().numpy()
        r = (self.states == RUNNING).sum(2).cpu().numpy()
        for qi, ri, li in zip(q, r, self.limits.tolist()):
            self.launch_bytes.append(
                k1_bytes(J, qi, ri, None if li < 0 else li))
        self.states = self.limits = None

    def _ready(self, prof) -> None:
        self.events = list(prof.events())

    def __exit__(self, *exc) -> None:
        self._mod.policy_eval_pass_batched = self._orig
        self.states = self.limits = None
        if self.prof is not None:          # the unit ended before the window
            self.prof.stop()
            self.prof = None
            self.events = self.wall = None

    def reduce(self) -> Optional[Dict]:
        """Busy time, kernels, K1's device time, the top device ops and
        the longest idle gaps by the host op under them; None when the
        window never closed or saw no device op."""
        if self.events is None or self.wall is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        dev = [e for e in self.events if e.device_type == cuda
               and not e.name.startswith("ProfilerStep")]
        host = [e for e in self.events if e.device_type != cuda
                and not e.name.startswith("ProfilerStep")]
        if not dev:
            return None
        spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
        merged: List[List[float]] = [list(spans[0])]
        for a, b in spans[1:]:
            if a > merged[-1][1]:
                merged.append([a, b])
            else:
                merged[-1][1] = max(merged[-1][1], b)
        busy_us = sum(b - a for a, b in merged)
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[short_name(e.name)] += (e.time_range.end
                                            - e.time_range.start)
        k1 = [e for e in dev if K1_KERNEL in e.name]
        kernels = [e for e in dev if not e.name.startswith(("Memcpy",
                                                            "Memset"))]
        return {
            "wall_s": self.wall, "busy_s": busy_us * 1e-6,
            "kernels": len(kernels), "k1_launches": self.active,
            "k1_count": len(k1),
            "k1_bytes": sum(self.launch_bytes),
            "k1_counted": len(self.launch_bytes),
            "k1_s": sum(e.time_range.end - e.time_range.start
                        for e in k1) * 1e-6,
            "device_ops": [[n, t * 1e-6] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": _idle_gaps(merged, host),
        }


_WRAPPERS = {"elementwise_kernel", "vectorized_elementwise_kernel",
             "unrolled_elementwise_kernel", "gpu_kernel_impl",
             "gpu_kernel_impl_nocast", "launch_kernel"}
_PART = re.compile(r"[A-Za-z_]\w*(?:Functor\w*|_kernel\w*|_impl\w*)")


def short_name(name: str) -> str:
    """A kernel's name without its template arguments: the outer
    function and, for PyTorch's elementwise launchers, the functor or
    kernel they run (``elementwise_kernel:pow_tensor_tensor_kernel``)."""
    clean = name.replace("(anonymous namespace)::", "")
    outer = re.match(r"void ([\w:]+)", clean)
    if outer is None:
        return clean[:40]
    head = outer.group(1).split("::")[-1]
    if head not in _WRAPPERS:
        return head
    inner = [p for p in _PART.findall(name) if p not in _WRAPPERS]
    return f"{head}:{inner[-1]}" if inner else head


def _idle_gaps(merged, host, top: int = 200) -> List[list]:
    """The longest gaps between busy stretches, summed by the innermost
    host op running at each gap's middle; the ten largest sums."""
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    if not gaps or not host:
        return []
    starts = np.array([e.time_range.start for e in host])
    ends = np.array([e.time_range.end for e in host])
    names = [e.name for e in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (names[cover[np.argmin(ends[cover] - starts[cover])]]
                if cover.size else "python between ops")
        out[name] += (b - a) * 1e-6
    return [[n, t] for n, t in sorted(out.items(), key=lambda kv: -kv[1])
            [:10]]
