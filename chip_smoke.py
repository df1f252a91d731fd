#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
     every kernel from the sources in the checkout, with ptxas's report;
  2. every kernel against its plain PyTorch version on the card, on the
     inputs of real-size passes (a Polaris-scale drain, forced end-time
     collisions, ``limit < J``, the largest J): bitwise, plus its time per
     launch beside the plain version's and the bound;
  3. the paper's §4.1 co-simulation (``--trace paper``: 150 jobs, 32
     nodes, paper pool, ``score``) through ``twin_loop`` on ``cuda`` and
     on ``cpu``: same metric table, policy mix and per-cycle starts;
  4. five Polaris-scale decision cycles (560 nodes, a 1,024-slot job
     table, ~100 running and ~600 queued, the k=32 DRAS sweep pool) fed
     through the event bus and ``SchedTwin.pump()``; then one more decide
     of that snapshot under ``torch.profiler`` (device busy share, kernels
     per cycle, K1's device time).

The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

POLARIS_NODES = 560          # ALCF Polaris compute nodes
POLARIS_SLOTS = 1024         # job-table capacity J
POLARIS_JOBS = 700           # backlog: ~100 running + ~600 queued
DRAS_POOL = "extended,wfp:a=1..5x5:tau=600..7200x5"   # k = 32
POLARIS_CYCLES = 5
MEM_RATE = 3.35e12           # H100 SXM HBM3, bytes/s (data sheet)
OP_RATE = 67e12              # H100 SXM non-tensor 32-bit rate, ops/s

K1 = dict(name="policy_eval_pass_batched", route="cuda",
          source="src/repro_torch/csrc/policy_eval.cu",
          replaces="src/repro/kernels/policy_eval.py:65")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def build_kernels():
    from repro_torch.kernels import build
    done = build.build(force=True, extra_flags=("-Xptxas", "-v"))
    for name, (seconds, log) in done.items():
        print(f"[build] {name}: nvcc {seconds:.2f} s "
              f"-> {build.library_path(name).name}")
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


# ---------------------------------------------------------- phase 4 input
def polaris_backlog(seed: int = 0):
    """The event stream of a Polaris-scale backlog: 700 Poisson arrivals
    with heavy-tailed walltimes (5 min .. 24 h), each started at arrival
    while it fits 560 nodes; the rest wait."""
    from repro_torch.cluster.workload import poisson_trace
    from repro_torch.core.events import Event, EventKind
    trace = poisson_trace(POLARIS_JOBS, POLARIS_NODES, 4.0, (1, 11),
                          (300.0, 86400.0), seed=seed, heavy_tail=True)
    events, free, n_run = [], POLARIS_NODES, 0
    for j in trace:
        events.append(Event(EventKind.QUEUEJOB, j.submit_t, j.job_id,
                            {"nodes": float(j.nodes),
                             "est_runtime": float(j.est_runtime)}))
        if j.nodes <= free and n_run == j.job_id:
            free -= j.nodes
            n_run += 1
            events.append(Event(EventKind.RUNJOB, j.submit_t, j.job_id))
    return trace, events, n_run


def make_twin(engine, on_qrun):
    from repro_torch.core.events import EventBus
    from repro_torch.core.twin import SchedTwin
    bus = EventBus()
    twin = SchedTwin(bus=bus, qrun=on_qrun, total_nodes=POLARIS_NODES,
                     max_jobs=POLARIS_SLOTS, pool=DRAS_POOL,
                     objective="score", engine=engine)
    return bus, twin


def polaris_snapshot(engine):
    """The mirror after the backlog is ingested (no decision taken)."""
    from repro_torch.core import sync
    from repro_torch.core.state import empty_state
    _, events, _ = polaris_backlog()
    st = empty_state(POLARIS_SLOTS, POLARIS_NODES, device="cpu")
    for ev in events:
        st, _ = sync.apply_event(st, ev)
    return st


# ---------------------------------------------------------------- phase 2
def synthetic_passes(torch, k, J, seed, collide, device="cuda"):
    """Random pass inputs at shape (k, J): queued-first orders, a shared
    rank limit below J, and (``collide``) end times on a 600 s grid so
    that many running jobs end together."""
    import numpy as np
    from repro_torch.core.state import QUEUED, RUNNING
    rng = np.random.default_rng(seed)
    state = rng.choice([0, QUEUED, RUNNING, 3], size=(k, J),
                       p=[0.1, 0.55, 0.15, 0.2]).astype(np.int32)
    nodes = rng.integers(1, 12, size=(k, J)).astype(np.int32)
    nodes[rng.random((k, J)) < 0.05] = 300
    est = rng.uniform(300.0, 86400.0, size=(k, J)).astype(np.float32)
    now = rng.uniform(0.0, 5e4, size=k).astype(np.float32)
    end = (now[:, None] + rng.uniform(0.0, 4e4, size=(k, J))).astype(
        np.float32)
    if collide:
        end = (np.floor(end / 600.0) * 600.0).astype(np.float32)
        est = (np.ceil(est / 600.0) * 600.0).astype(np.float32)
    used = np.where(state == RUNNING, nodes, 0).sum(1)
    free0 = np.maximum(POLARIS_NODES - used, rng.integers(0, 40, size=k))
    keys = np.where(state == QUEUED, rng.random((k, J)), np.inf)
    order = np.argsort(keys, axis=1, kind="stable").astype(np.int32)
    limit = int((state == QUEUED).sum(1).max())
    dev = device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(order), t(state), t(nodes), t(est), t(end),
            t(free0.astype(np.int32)), t(now),
            torch.tensor([limit], dtype=torch.int32, device=dev))


def capture_drain_passes(torch, engine, snapshot, every=20):
    """The pass inputs of one real drain of the Polaris snapshot: the
    first pass, then every ``every``-th lock-step iteration."""
    from repro_torch.core import des
    from repro_torch.core.engine import make_order_fn
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.state import QUEUED
    from repro_torch.kernels import policy_eval as pe
    pool = parse_pool(DRAS_POOL).spec.to(engine.device)
    states = des.broadcast_state(snapshot.to(engine.device),
                                 pool.family.shape[0])
    order_fn = make_order_fn(states, pool, engine.plan(pool),
                             states.jobs.state == QUEUED)
    captured, step = [], [0]

    def pass_fn(st, order, limit):
        args = (order, st.jobs.state, st.jobs.nodes, st.jobs.est_runtime,
                st.jobs.end_t, st.free_nodes, st.now, limit)
        if step[0] % every == 0:
            captured.append(tuple(a.clone() for a in args))
        step[0] += 1
        return pe.policy_eval_pass_batched(*args)[0]

    des.simulate_to_drain_batched(states, order_fn, pass_fn)
    return captured, step[0]


def time_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def k1_bound_ms(torch, args):
    """Least time for one pass on these inputs: bytes (each input read
    once, each output written once) over the HBM rate against the
    lexicographic count's compare-adds (2 ops per pair, over the running
    and pass-1-started jobs of each fork that has a head) over the
    non-tensor rate."""
    from repro_torch.core.state import QUEUED, RUNNING
    order, state, nodes, est, end_t, free0, now, limit = args
    k, J = order.shape
    nbytes = k * J * (4 * 5) + k * (4 + 4) + 4 + k * J * 1 + k * 4
    idx = order.long()
    ranks = torch.arange(J, device=order.device)
    q_rank = torch.gather(state == QUEUED, 1, idx) & (ranks < limit.long())
    need = torch.cumsum(torch.where(q_rank, torch.gather(nodes, 1, idx), 0),
                        1)
    started = q_rank & (need <= free0[:, None])
    has_head = (q_rank & ~started).any(1)
    running = (state == RUNNING).sum(1) + started.sum(1)
    ops = int((2 * running.long() ** 2 * has_head).sum())
    bytes_ms = nbytes / MEM_RATE * 1e3
    ops_ms = ops / OP_RATE * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def kernel_vs_plain(torch, engine, snapshot):
    from repro_torch.core.backfill import schedule_pass_batched
    from repro_torch.kernels import policy_eval as pe
    drain_inputs, n_iter = capture_drain_passes(torch, engine, snapshot)
    cases = [(f"drain pass {i * 20}", a) for i, a in enumerate(drain_inputs)]
    for seed in range(6):
        cases.append((f"collide k=32 J=1024 seed={seed}",
                      synthetic_passes(torch, 32, POLARIS_SLOTS, seed, True)))
    for seed in range(3):
        cases.append((f"random k=32 J=1024 seed={seed}",
                      synthetic_passes(torch, 32, POLARIS_SLOTS, 10 + seed,
                                       False)))
    cases.append(("collide k=8 J=4096 (largest J)",
                  synthetic_passes(torch, 8, pe.MAX_J, 99, True)))
    print(f"[k1] real drain: {n_iter} lock-step passes at k=32 "
          f"J={POLARIS_SLOTS}; comparing {len(cases)} pass inputs")
    worst = 0
    for name, args in cases:
        s_k, f_k = pe.policy_eval_pass_batched(*args)
        s_p, f_p = schedule_pass_batched(*args)
        torch.cuda.synchronize()
        err = max(int((s_k != s_p).sum()), int((f_k - f_p).abs().max()))
        if err or f_k.dtype != torch.int32 or s_k.dtype != torch.bool:
            raise SystemExit(f"[k1] MISMATCH on {name}: {err} differing "
                             f"entries")
        worst = max(worst, err)
    print(f"[k1] started and free bitwise equal to the plain version on "
          f"all {len(cases)} inputs (tolerance: none)")
    first = drain_inputs[0]
    launch = raw_launch(torch, pe, first)
    ms = time_ms(torch, launch, 500)
    wrapper_ms = time_ms(torch, lambda: pe.policy_eval_pass_batched(*first),
                         200)
    plain_ms = time_ms(torch, lambda: schedule_pass_batched(*first), 10)
    ms2 = time_ms(torch, launch, 500)
    bound, bound_by = k1_bound_ms(torch, first)
    print(f"[k1] first pass of the drain (k=32, J={POLARIS_SLOTS}): kernel "
          f"{ms * 1e3:.2f} / {ms2 * 1e3:.2f} us per launch (back-to-back "
          f"launches of the C entry point), {wrapper_ms * 1e3:.2f} us per "
          f"call through the Python wrapper, plain {plain_ms:.3f} ms, "
          f"bound {bound * 1e3:.3f} us ({bound_by})")
    return dict(max_abs_err=float(worst), ms=min(ms, ms2),
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


def raw_launch(torch, pe, args):
    """K1 launched straight through its C entry point on fixed buffers,
    so that back-to-back launches time the kernel, not the wrapper's
    checks and allocations."""
    k, J = args[0].shape
    started = torch.empty((k, J), dtype=torch.bool, device="cuda")
    free = torch.empty((k,), dtype=torch.int32, device="cuda")
    fn = pe._kernel()
    ptrs = [a.data_ptr() for a in args] + [started.data_ptr(),
                                           free.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*ptrs, k, J, stream) != 0:
            raise SystemExit("[k1] launch failed")
    return launch


# ---------------------------------------------------------------- phase 3
def paper_cosim(device):
    from repro_torch.launch import twin_loop
    args = twin_loop.build_parser().parse_args(
        ["--trace", "paper", "--device", device])
    t0 = time.perf_counter()
    report, twin, _ = twin_loop.co_simulate(args)
    wall = time.perf_counter() - t0
    cycles = [(c.policy, tuple(c.started_jobs)) for c in twin.telemetry.cycles]
    lat = twin.telemetry.cycle_latency_stats()
    print(f"[cosim] {device}: {report.n_jobs} jobs, {lat['n']} cycles in "
          f"{wall:.1f} s; cycle latency mean {lat['mean_s'] * 1e3:.2f} ms, "
          f"p50 {lat['p50_s'] * 1e3:.2f} ms; policy mix "
          f"{twin.telemetry.policy_start_distribution()}")
    return report.metric_dict(), twin.telemetry.policy_start_distribution(), \
        cycles


def check_cosim(pe):
    pe.LAUNCHES = 0
    cuda = paper_cosim("cuda")
    launches = pe.LAUNCHES
    cpu = paper_cosim("cpu")
    print(f"[cosim] metrics cuda {cuda[0]}")
    if cuda[0] != cpu[0] or cuda[1] != cpu[1] or cuda[2] != cpu[2]:
        raise SystemExit("[cosim] cuda and cpu co-simulations differ")
    if launches == 0:
        raise SystemExit("[cosim] the cuda run never launched K1")
    print(f"[cosim] cuda == cpu: metric table, policy mix and all "
          f"{len(cuda[2])} per-cycle start sets identical; K1 launches "
          f"on cuda: {launches}")


# ---------------------------------------------------------------- phase 4
def polaris_cycles(torch, engine, pe):
    """Five decision cycles through the normal entry point: events on the
    bus, ``SchedTwin.pump()``.  The qrun callback stands in for the
    scheduler: it publishes RUNJOB for every started job."""
    from repro_torch.core.events import Event, EventKind
    pending = []

    def on_qrun(job_ids, t):
        pending.extend(Event(EventKind.RUNJOB, t, j) for j in job_ids)

    bus, twin = make_twin(engine, on_qrun)
    trace, events, n_run = polaris_backlog()
    for ev in events:
        bus.publish(ev)
    rows = []
    pe.LAUNCHES = 0
    for cycle in range(POLARIS_CYCLES):
        if cycle:
            for ev in pending:
                bus.publish(ev)
            pending.clear()
            # the three running jobs due first finish at their predicted end
            st = twin.state.jobs
            running = (st.state == 2).nonzero().flatten().tolist()
            running.sort(key=lambda j: float(st.end_t[j]))
            for j in running[:3]:
                bus.publish(Event(EventKind.JOBOBIT,
                                  max(float(st.end_t[j]),
                                      float(twin.state.now)), j))
        before = pe.LAUNCHES
        n_before = len(twin.telemetry.cycles)
        twin.pump()
        torch.cuda.synchronize()
        rec = twin.telemetry.cycles[-1]
        assert len(twin.telemetry.cycles) == n_before + 1
        jobs = twin.state.jobs
        n_q = int((jobs.state == 1).sum())
        n_r = int((jobs.state == 2).sum())
        rows.append(rec.wall_seconds)
        print(f"[polaris] cycle {cycle}: {rec.wall_seconds * 1e3:.1f} ms, "
              f"{pe.LAUNCHES - before} lock-step drain iterations "
              f"(= K1 launches), running {n_r} queued {n_q}, winner "
              f"{rec.policy}, started {rec.n_started}")
        if not all(math.isfinite(c) for c in rec.costs.values()):
            raise SystemExit(f"[polaris] cycle {cycle}: non-finite costs")
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit("[polaris] the main path never launched K1")
    print(f"[polaris] {POLARIS_CYCLES} cycles, {len(trace)} jobs "
          f"({n_run} started at ingest) on {POLARIS_NODES} nodes, "
          f"J={POLARIS_SLOTS}, k=32: wall mean "
          f"{statistics.mean(rows) * 1e3:.1f} ms, p50 "
          f"{statistics.median(rows) * 1e3:.1f} ms; K1 launches {launches}")
    return launches


def profile_cycle(torch, engine, snapshot):
    """One more Polaris-scale decide, untraced then under torch.profiler:
    the device's busy share of the traced cycle (the union of kernel
    intervals over its wall time), kernels per cycle, K1's share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.policies import parse_pool
    pool = parse_pool(DRAS_POOL).spec.to(engine.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    int(engine.decide(snapshot, pool).policy_index)
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        int(engine.decide(snapshot, pool).policy_index)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] the profiler saw no device kernels: busy share "
              "not measured")
        return
    busy, lo, hi = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    k1_us = sum(e.device_time_total for e in prof.key_averages()
                if "pass_kernel" in e.key)
    print(f"[profile] Polaris decide: untraced {untraced * 1e3:.1f} ms; "
          f"traced {traced * 1e3:.1f} ms with {len(spans)} device kernels, "
          f"device busy {busy / 1e3:.1f} ms "
          f"({100.0 * busy / (traced * 1e6):.1f}% of the traced wall), "
          f"K1 {k1_us / 1e3:.1f} ms of it")
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    for e in [e for e in top if not e.key.startswith("aten::")][:6]:
        print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x {e.key[:60]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from repro_torch.core.engine import DrainEngine
    from repro_torch.kernels import policy_eval as pe

    t_start = time.perf_counter()
    print(f"[card] {card_line()}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_kernels()
    engine = DrainEngine(backend="cuda", device="cuda")
    snapshot = polaris_snapshot(engine)
    k1 = kernel_vs_plain(torch, engine, snapshot)
    check_cosim(pe)
    launches = polaris_cycles(torch, engine, pe)
    profile_cycle(torch, engine, snapshot)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [dict(K1, launches=launches, **k1,
                                       library_ms=None)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
