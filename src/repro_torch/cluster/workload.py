"""Workload generation — port of ``repro/cluster/workload.py`` (numpy
only, copied so that a seed gives the identical trace).

``paper_synthetic_trace`` reproduces the §4.1 evaluation trace: 150 jobs
in four phases on a 32-node cluster, 5 s inter-arrival.  True runtimes
are a fraction of the requested walltime (users overestimate, §3.2); the
twin never sees them.  ``poisson_trace`` / ``bursty_trace`` are the
generic family: flat Poisson arrivals and the same process under a
sinusoidal (diurnal) rate; ``arch_job_mix`` draws training, prefill and
decode jobs of the ten model architectures over a pod fleet.  ``ScenarioSet`` / ``stack_scenarios`` pad
and stack traces into the replay engine's scenario axis; ``read_swf`` /
``write_swf`` handle the Standard Workload Format.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobSpec:
    job_id: int
    submit_t: float
    nodes: int
    est_runtime: float   # user-requested walltime (visible to scheduler/twin)
    true_runtime: float  # ground truth (emulator only)
    tag: str = ""        # phase or job-class label


@dataclasses.dataclass(frozen=True)
class Phase:
    n_jobs: int
    nodes: Tuple[int, int]        # inclusive range
    walltime: Tuple[float, float] # seconds, inclusive range
    tag: str


PAPER_PHASES: Sequence[Phase] = (
    Phase(25, (2, 4), (60.0, 180.0), "warmup"),
    Phase(35, (16, 20), (500.0, 700.0), "burst"),
    Phase(40, (6, 8), (200.0, 300.0), "steady"),
    Phase(50, (2, 4), (30.0, 90.0), "tail"),  # "short-job tail ... of seconds"
)
PAPER_TOTAL_NODES = 32
PAPER_ARRIVAL_GAP = 5.0  # seconds per job


def paper_synthetic_trace(seed: int = 0,
                          accuracy: Tuple[float, float] = (0.5, 1.0),
                          arrival_gap: float = PAPER_ARRIVAL_GAP,
                          phases: Sequence[Phase] = PAPER_PHASES,
                          rng: Optional[np.random.Generator] = None,
                          ) -> List[JobSpec]:
    """The §4.1 four-phase synthetic workload (150 jobs).

    ``accuracy`` is the true/estimated runtime ratio range; estimates are
    the phase walltimes.  Deterministic given ``seed``; pass ``rng=`` to
    draw from an explicit caller-owned generator instead (resumable
    streams — ``seed`` is then ignored).
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    jid = 0
    for ph in phases:
        for _ in range(ph.n_jobs):
            nodes = int(rng.integers(ph.nodes[0], ph.nodes[1] + 1))
            est = float(rng.uniform(ph.walltime[0], ph.walltime[1]))
            acc = float(rng.uniform(accuracy[0], accuracy[1]))
            jobs.append(JobSpec(
                job_id=jid, submit_t=t, nodes=nodes,
                est_runtime=est, true_runtime=max(1.0, est * acc),
                tag=ph.tag))
            jid += 1
            t += arrival_gap
    return jobs


def _sample_job(rng: np.random.Generator, jid: int, t: float,
                total_nodes: int, node_range: Tuple[int, int],
                walltime_range: Tuple[float, float],
                accuracy: Tuple[float, float], heavy_tail: bool,
                tag: str) -> JobSpec:
    """One job draw shared by the Poisson-family trace generators
    (identical RNG call order: nodes, est, acc)."""
    lo_w, hi_w = walltime_range
    nodes = int(rng.integers(node_range[0],
                             min(node_range[1], total_nodes) + 1))
    if heavy_tail:
        mu = np.log(np.sqrt(lo_w * hi_w))
        sigma = np.log(hi_w / lo_w) / 4.0
        est = float(np.clip(rng.lognormal(mu, sigma), lo_w, hi_w))
    else:
        est = float(rng.uniform(lo_w, hi_w))
    acc = float(rng.uniform(accuracy[0], accuracy[1]))
    return JobSpec(jid, t, nodes, est, max(1.0, est * acc), tag)


def poisson_trace(n_jobs: int, total_nodes: int, mean_gap: float,
                  node_range: Tuple[int, int],
                  walltime_range: Tuple[float, float],
                  seed: int = 0,
                  accuracy: Tuple[float, float] = (0.3, 1.0),
                  heavy_tail: bool = True,
                  rng: Optional[np.random.Generator] = None,
                  ) -> List[JobSpec]:
    """Generic Poisson-arrival workload with (optionally) lognormal
    walltimes — matches the wide Polaris-style variability of Figure 1.
    ``rng=`` substitutes an explicit caller-owned generator for the
    ``seed``-derived one (deterministic, resumable streams)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        jobs.append(_sample_job(rng, jid, t, total_nodes, node_range,
                                walltime_range, accuracy, heavy_tail,
                                "poisson"))
    return jobs


def bursty_trace(n_jobs: int, total_nodes: int, mean_gap: float,
                 node_range: Tuple[int, int],
                 walltime_range: Tuple[float, float],
                 seed: int = 0,
                 accuracy: Tuple[float, float] = (0.3, 1.0),
                 heavy_tail: bool = True,
                 period: float = 3600.0,
                 amplitude: float = 0.8,
                 phase: float = 0.0,
                 rng: Optional[np.random.Generator] = None,
                 ) -> List[JobSpec]:
    """Bursty/diurnal arrivals: a nonhomogeneous Poisson process whose
    rate is sinusoidally modulated on top of ``poisson_trace``'s flat
    rate,

        rate(t) = (1 + amplitude * sin(2*pi*t/period + phase)) / mean_gap,

    so arrivals alternate between rush-hour bursts (rate up to
    (1+amplitude)x the mean) and quiet troughs — the regime where
    backfill-friendly policies and aggressive aging pull apart, which a
    flat-Poisson evaluation never exercises.  ``amplitude`` in [0, 1);
    0 reduces to ``poisson_trace``'s marginal statistics.  Job sizes
    and walltimes are drawn exactly as in ``poisson_trace``.  ``rng=``
    substitutes an explicit caller-owned generator for the
    ``seed``-derived one — the same knob the on-device fan exposes via
    ``FanSpec.seed``, so host traces and device fans are both
    deterministic and resumable.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed) if rng is None else rng
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        # thin an exponential draw by the instantaneous rate at t: the
        # local mean gap is mean_gap / (1 + A sin(...)).
        rate = 1.0 + amplitude * np.sin(2.0 * np.pi * t / period + phase)
        t += float(rng.exponential(mean_gap) / max(rate, 1e-9))
        jobs.append(_sample_job(rng, jid, t, total_nodes, node_range,
                                walltime_range, accuracy, heavy_tail,
                                "bursty"))
    return jobs


# ----------------------------------------------------------------------
# LM-fleet job classes: the twin as an accelerator-fleet scheduler
# (repro_torch.examples.fleet_twin).
# ----------------------------------------------------------------------

#: pods requested per job class, per architecture scale bucket.
_ARCH_PODS = {
    "granite-20b": 2, "granite-3-2b": 1, "llama3.2-1b": 1,
    "qwen2-72b": 8, "internvl2-76b": 8, "deepseek-v2-lite-16b": 2,
    "olmoe-1b-7b": 1, "rwkv6-7b": 2, "recurrentgemma-2b": 1,
    "whisper-small": 1,
}


def arch_job_mix(n_jobs: int, total_pods: int = 32, seed: int = 0,
                 mean_gap: float = 30.0,
                 rng: Optional[np.random.Generator] = None) -> List[JobSpec]:
    """Jobs for an accelerator fleet: training jobs (long, many pods),
    prefill batches (short, few pods), decode services (medium).  Pod
    counts come from each architecture's footprint (``_ARCH_PODS``)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    arches = list(_ARCH_PODS)
    classes = (
        ("train", 4.0, (1800.0, 7200.0)),
        ("prefill", 1.0, (120.0, 600.0)),
        ("decode", 2.0, (600.0, 1800.0)),
    )
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(n_jobs):
        t += float(rng.exponential(mean_gap))
        arch = arches[int(rng.integers(len(arches)))]
        cname, scale, wt = classes[int(rng.integers(len(classes)))]
        pods = min(max(1, int(_ARCH_PODS[arch] * scale)), total_pods)
        est = float(rng.uniform(*wt))
        acc = float(rng.uniform(0.4, 1.0))
        jobs.append(JobSpec(jid, t, pods, est, max(1.0, est * acc),
                            tag=f"{arch}:{cname}"))
    return jobs


# ----------------------------------------------------------------------
# Scenario stacking — the replay engine's scenario axis (DESIGN.md §6).
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSet:
    """S heterogeneous traces padded and stacked to one (S, J) block.

    The device-side input of ``engine.replay`` / ``engine.replay_grid``:
    slot j of scenario s is job j of trace s (submission order), padding
    slots carry ``valid=False`` and an ``inf`` arrival so they never
    enter any simulation.  ``total_nodes`` is per-scenario — scenarios
    of different cluster sizes ride the same batch.

    Job fields are quantized to f32 — the device dtype — so host-side
    (f64) and device-side event arithmetic agree bit-for-bit (sums of
    in-range f32 values are exact in both precisions).
    """

    submit_t: np.ndarray      # (S, J) f32, 0.0 on padding
    nodes: np.ndarray         # (S, J) i32, 0 on padding
    est_runtime: np.ndarray   # (S, J) f32, 0.0 on padding
    true_runtime: np.ndarray  # (S, J) f32, 0.0 on padding
    valid: np.ndarray         # (S, J) bool — real (non-padding) jobs
    n_jobs: np.ndarray        # (S,) i32
    total_nodes: np.ndarray   # (S,) i32

    @property
    def n_scenarios(self) -> int:
        return self.submit_t.shape[0]

    @property
    def capacity(self) -> int:
        return self.submit_t.shape[1]


def stack_scenarios(traces: Sequence[Sequence[JobSpec]],
                    total_nodes: Union[int, Sequence[int]],
                    max_jobs: Optional[int] = None) -> ScenarioSet:
    """Pad + stack traces into a ``ScenarioSet``.

    ``max_jobs`` defaults to the next power of two above the longest
    trace (matching ``ClusterEmulator``'s slot sizing; padding slots
    never influence replay dynamics, so any J ≥ max trace length gives
    identical results).  Traces must be in submission order — slot
    index is the arrival cursor — and every job must fit its scenario's
    cluster *or* the replay will flag that scenario deadlocked.

    Lists of ``JobSpec`` with exact ``int`` ids and nodes and exact
    ``float`` times are read in one native pass (``csrc/stack_scenarios.c``);
    any other input, or one that fails a check, takes the plain loop,
    which gives the same tables and raises the same errors.  A ``stack``
    span counts the jobs (``stack.jobs``) and those the native pass
    wrote (``stack.native_jobs``).
    """
    from repro_torch.core import telemetry
    spans = telemetry.SPANS
    with spans.span("stack"):
        S = len(traces)
        if S == 0:
            raise ValueError("need at least one trace")
        if isinstance(total_nodes, (int, np.integer)):
            totals = [int(total_nodes)] * S
        else:
            totals = [int(t) for t in total_nodes]
            if len(totals) != S:
                raise ValueError(
                    f"{len(totals)} total_nodes for {S} traces")
        longest = max(len(t) for t in traces)
        if max_jobs is None:
            max_jobs = max(64,
                           1 << int(np.ceil(np.log2(max(longest, 1) + 1))))
        if longest > max_jobs:
            raise ValueError(f"longest trace has {longest} jobs > {max_jobs}")

        shape = (S, max_jobs)
        out = ScenarioSet(
            submit_t=np.zeros(shape, dtype=np.float32),
            nodes=np.zeros(shape, dtype=np.int32),
            est_runtime=np.zeros(shape, dtype=np.float32),
            true_runtime=np.zeros(shape, dtype=np.float32),
            valid=np.zeros(shape, dtype=bool),
            n_jobs=np.asarray([len(t) for t in traces], dtype=np.int32),
            total_nodes=np.asarray(totals, dtype=np.int32),
        )
        jobs = int(out.n_jobs.sum())
        spans.count("stack.jobs", jobs)
        native = _native_stack()
        if native is not None and native(
                traces, JobSpec, S, max_jobs, out.submit_t.ctypes.data,
                out.nodes.ctypes.data, out.est_runtime.ctypes.data,
                out.true_runtime.ctypes.data, out.valid.ctypes.data) == jobs:
            spans.count("stack.native_jobs", jobs)
        else:
            spans.count("stack.native_jobs", 0)
            _stack_rows(traces, out)
    return out


@functools.lru_cache(maxsize=None)
def _native_stack():
    """``stack_rows`` of the native pass, or None where this host cannot
    build it (no C compiler or no ``Python.h``)."""
    from repro_torch.kernels import build
    try:
        fn = build.load_host("stack_scenarios").stack_rows
    except (RuntimeError, OSError):
        return None
    fn.argtypes = (ctypes.py_object, ctypes.py_object, ctypes.c_ssize_t,
                   ctypes.c_ssize_t, *(ctypes.c_void_p,) * 5)
    fn.restype = ctypes.c_ssize_t
    return fn


def _stack_rows(traces: Sequence[Sequence[JobSpec]],
                out: ScenarioSet) -> None:
    """The plain loop: checks each trace and writes its rows of ``out``."""
    for s, trace in enumerate(traces):
        ids = [j.job_id for j in trace]
        if ids != list(range(len(trace))):
            # slot j IS job j: the host emulator keys its arrays by
            # job_id, the replay by position — permuted ids would make
            # the two silently disagree
            raise ValueError(
                f"trace {s}: job_id must equal trace position")
        sub = np.asarray([j.submit_t for j in trace], dtype=np.float32)
        if np.any(np.diff(sub) < 0):
            raise ValueError(f"trace {s} not in submission order")
        n = len(trace)
        out.submit_t[s, :n] = sub
        out.nodes[s, :n] = [j.nodes for j in trace]
        out.est_runtime[s, :n] = [j.est_runtime for j in trace]
        out.true_runtime[s, :n] = [j.true_runtime for j in trace]
        out.valid[s, :n] = True


def make_scenario(trace: Sequence[JobSpec], total_nodes: int,
                  max_jobs: Optional[int] = None) -> ScenarioSet:
    """One trace as an S=1 ``ScenarioSet`` (``engine.replay``'s input)."""
    return stack_scenarios([trace], total_nodes, max_jobs=max_jobs)


def split_scenarios(rng: np.random.Generator,
                    trace_fn: Callable[[np.random.Generator],
                                       Sequence[JobSpec]],
                    n_train: int, n_heldout: int,
                    total_nodes: Union[int, Sequence[int]],
                    max_jobs: Optional[int] = None,
                    ) -> Tuple[ScenarioSet, ScenarioSet]:
    """Deterministic train/held-out split for policy training.

    Draws ``n_train + n_heldout`` traces SEQUENTIALLY from the single
    caller-owned ``rng`` (``trace_fn(rng)`` per trace, the generators'
    ``rng=`` idiom), then partitions by index: the first ``n_train``
    traces are the training set, the last ``n_heldout`` the held-out
    set.  The two sets are disjoint segments of one stream — an index
    partition, not a re-draw — so train/eval leakage is structurally
    impossible, and the same rng state reproduces the same split
    bitwise.  Both sets are padded to a COMMON ``max_jobs`` so a θ
    evaluated on either sees identical table shapes (one compiled
    replay shape per S).
    """
    if n_train < 1 or n_heldout < 1:
        raise ValueError(
            f"need n_train >= 1 and n_heldout >= 1, got "
            f"{n_train}/{n_heldout}")
    traces = [list(trace_fn(rng)) for _ in range(n_train + n_heldout)]
    if max_jobs is None:
        longest = max(len(t) for t in traces)
        max_jobs = max(64, 1 << int(np.ceil(np.log2(longest + 1))))
    if isinstance(total_nodes, (int, np.integer)):
        tn_train: Union[int, Sequence[int]] = int(total_nodes)
        tn_held: Union[int, Sequence[int]] = int(total_nodes)
    else:
        totals = [int(t) for t in total_nodes]
        if len(totals) != n_train + n_heldout:
            raise ValueError(
                f"{len(totals)} total_nodes for {n_train + n_heldout} "
                f"traces")
        tn_train, tn_held = totals[:n_train], totals[n_train:]
    return (stack_scenarios(traces[:n_train], tn_train, max_jobs=max_jobs),
            stack_scenarios(traces[n_train:], tn_held, max_jobs=max_jobs))


def slice_scenarios(scenarios: ScenarioSet, start: int,
                    stop: int) -> ScenarioSet:
    """Rows ``[start, stop)`` as a ``ScenarioSet`` of numpy VIEWS — no
    copies, so cutting a large scenario set into fixed-size blocks
    costs nothing on the host."""
    cut = lambda x: x[start:stop]
    return ScenarioSet(
        submit_t=cut(scenarios.submit_t),
        nodes=cut(scenarios.nodes),
        est_runtime=cut(scenarios.est_runtime),
        true_runtime=cut(scenarios.true_runtime),
        valid=cut(scenarios.valid),
        n_jobs=cut(scenarios.n_jobs),
        total_nodes=cut(scenarios.total_nodes),
    )


def pad_scenarios(scenarios: ScenarioSet, multiple: int) -> ScenarioSet:
    """Pad the scenario axis up to the next multiple of ``multiple``
    with INERT rows: ``valid`` all-False (so every arrival is ``inf``
    and the fork is born drained — it never becomes live, never queues
    a job, and therefore never influences the lock-step dynamic pass
    bound of real forks), zero jobs, ``total_nodes=1`` (keeps the
    per-scenario metric denominators finite; padded-row metrics are
    dropped before selection anyway).  Identity when S already divides.
    """
    S = scenarios.n_scenarios
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    pad = (-S) % multiple
    if pad == 0:
        return scenarios
    J = scenarios.capacity
    z = lambda dt: np.zeros((pad, J), dtype=dt)
    cat = np.concatenate
    return ScenarioSet(
        submit_t=cat([scenarios.submit_t, z(np.float32)]),
        nodes=cat([scenarios.nodes, z(np.int32)]),
        est_runtime=cat([scenarios.est_runtime, z(np.float32)]),
        true_runtime=cat([scenarios.true_runtime, z(np.float32)]),
        valid=cat([scenarios.valid, z(bool)]),
        n_jobs=cat([scenarios.n_jobs,
                    np.zeros((pad,), dtype=np.int32)]),
        total_nodes=cat([scenarios.total_nodes,
                         np.ones((pad,), dtype=np.int32)]),
    )


# ----------------------------------------------------------------------
# Conversions & SWF I/O
# ----------------------------------------------------------------------

def trace_to_arrays(trace: Sequence[JobSpec]) -> Dict[str, np.ndarray]:
    return {
        "submit_t": np.array([j.submit_t for j in trace], dtype=np.float32),
        "nodes": np.array([j.nodes for j in trace], dtype=np.int32),
        "est_runtime": np.array([j.est_runtime for j in trace],
                                dtype=np.float32),
        "true_runtime": np.array([j.true_runtime for j in trace],
                                 dtype=np.float32),
    }


def write_swf(trace: Sequence[JobSpec], path: str) -> None:
    """Minimal Standard Workload Format writer (fields we use)."""
    with open(path, "w") as f:
        f.write("; SchedTwin synthetic trace\n")
        for j in trace:
            # id submit wait run nproc cpu mem reqproc reqtime ...
            f.write(f"{j.job_id + 1} {j.submit_t:.0f} -1 "
                    f"{j.true_runtime:.0f} {j.nodes} -1 -1 "
                    f"{j.nodes} {j.est_runtime:.0f} -1\n")


def read_swf(path: str, max_jobs: Optional[int] = None) -> List[JobSpec]:
    jobs: List[JobSpec] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            parts = line.split()
            jid = len(jobs)
            submit = float(parts[1])
            run = max(1.0, float(parts[3]))
            nproc = int(parts[7]) if int(parts[7]) > 0 else int(parts[4])
            req = float(parts[8]) if float(parts[8]) > 0 else run
            jobs.append(JobSpec(jid, submit, max(1, nproc), req, run, "swf"))
            if max_jobs is not None and len(jobs) >= max_jobs:
                break
    return jobs


def trace_stats(trace: Sequence[JobSpec]) -> Dict[str, float]:
    """Figure-1-style distribution summary."""
    nodes = np.array([j.nodes for j in trace])
    rt = np.array([j.true_runtime for j in trace])
    return {
        "n_jobs": len(trace),
        "nodes_min": float(nodes.min()), "nodes_p50": float(np.median(nodes)),
        "nodes_max": float(nodes.max()),
        "runtime_min_s": float(rt.min()),
        "runtime_p50_s": float(np.median(rt)),
        "runtime_max_s": float(rt.max()),
        "node_seconds": float((nodes * rt).sum()),
    }
