#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
     every kernel from the sources in the checkout (one process per
     source, all started together), with ptxas's report;
  2. K1 against its plain PyTorch version on the card, on the inputs of
     real-size passes (a Polaris-scale drain, forced end-time collisions,
     ``limit < J``, the largest J): bitwise, plus its time per launch on
     the drain's first pass and its mean over the captured drain passes,
     beside the plain version's and the bound, and per fork of those
     passes R (running and just-started jobs) and n_cand (the ranks the
     backfill walk decides);
  3. the paper's §4.1 co-simulation (``--trace paper``: 150 jobs, 32
     nodes, paper pool, ``score``) through ``twin_loop`` on ``cuda`` and
     on ``cpu``: same metric table, policy mix and per-cycle starts;
  4. five Polaris-scale decision cycles (560 nodes, a 1,024-slot job
     table, ~100 running and ~600 queued, the k=32 DRAS sweep pool) fed
     through the event bus and ``SchedTwin.pump()``; then one more decide
     of that snapshot under ``torch.profiler`` (device busy share, kernels
     per cycle, K1's device time and launches);
  5. K1' (the pass on one shared snapshot) through ``ops.twin_schedule_pass``
     on the six Polaris mirrors of phase 4 (k=32, J=1024) and on forced
     collisions: bitwise against its plain version, time and bound;
  6. K4 (flash attention): ptxas's registers, spills and shared memory
     per head dim of the bf16 kernel; K4 against its plain version at
     llama3.2-1b's prefill shapes (B=1, Hq=32, Hkv=8, D=64; S 1000 and
     2048 bf16 causal, 1000 f32, 1000 non-causal), and at
     recurrentgemma-2b's local layer (bf16, Hq=10, Hkv=1, D=256, window
     2048 at S 2048 and 3072, window 100 at S 1000); its time (launches
     of the C entry, timed in turns with ``scaled_dot_product_attention``:
     kernel, sdpa, sdpa, kernel) beside SDPA's, the plain version's and
     the bound;
  7. K3 (WKV6, chunked: 16 steps a link of its serial chain, products
     on the tensor cores in 3xTF32) against its plain version at
     rwkv6-7b's prefill shapes (B=1, H=64, N=64, S 1000 and 1024, f32):
     within atol = rtol = 2e-4, with times and bound;
  8. K2 (the RG-LRU scan), both entries, at recurrentgemma-2b's prefill
     shape (B=1, W=2560, S 2048 and 3072): ``rglru`` (f32) against
     ``rglru_scan`` and the gated entry (the layer between its matrix
     products, bf16, extreme gate inputs included) against
     ``rglru_gated_scan``, bitwise, with times, plain times and bounds;
     then the gated entry at a decode step (B=2, S=1, h in place);
  9. llama3.2-1b at full width (random bf16 weights) served through
     ``ServingEngine``: 8 requests of 128-1024 prompt tokens, 4 slots,
     max_seq 2048, 16 new tokens each, with the kernels and then with
     the plain versions (``--backend reference``): first-token logits
     within ``LOGIT_TOL``, token streams equal or each divergence a near
     tie; tokens/s, prefill and decode times, K4 launches (16 a prefill);
 10. rwkv6-7b at full width, cut to 16 of its 32 layers, the same way:
     4 requests of 128-768 tokens, 2 slots, max_seq 1024, 8 new tokens;
     K3 launches (16 a prefill);
 11. recurrentgemma-2b at full width the same way: 4 requests of
     256-3072 tokens (one at least past the 2048-token window), 2 slots,
     max_seq 4096, 8 new tokens; K2 (18 a prefill and 18 a decode step,
     its gated entry) and K4 (8 a prefill, windowed, D=256) launches.
     Each serving phase's profile counts PyTorch's elementwise kernels
     in a prefill and a decode step;
 12. a Polaris-scale replay grid through ``DrainEngine.replay_grid``: 8
     scenarios of 500 heavy-tailed Poisson jobs on 560 nodes (J=1024)
     x the k=32 DRAS pool = 256 forks, goal ``score``, K1 in every step.
     Bitwise against ``backend="reference"`` on the card (times,
     deadlocks, events, iterations, passes, costs, winners; K1 never
     launched there) and against the port's host emulator on two
     (scenario, policy) pairs, whose ``run(fast=True)`` reports equal
     the host loop's; the grid's wall after a warm run, iterations,
     passes, K1's launches and time a launch, host reads; the same
     replay block by block, its second block under
     ``torch.cuda.set_sync_debug_mode("error")``, four blocks under
     ``torch.profiler`` (device busy share, kernels per iteration), K1
     on one of their passes (k=256) against its plain version with its
     time, the plain time and the bound; the
     DRAS pool's priority keys on the card against the CPU's in ulp on
     phase 4's mirror and on the deepest replay queue (C3); and
     ``twin_loop --replay-grid 8`` on ``cuda`` and ``cpu``, same table;
 13. fans, races and ensembles at Polaris scale, K1 the pass of every
     fork: (a) the threefry draws of 512 fold-in chains (seed 0, s
     0..7, phi 0..63; J=1024 normals, a phase and a uniform pair each)
     on the card against the CPU; (b) ``decide_fan`` on phase 4's
     mirror (F=16, runtime noise 0.3, failures 0.1, ``p95:avg_wait``:
     k=512), ``cuda`` bitwise ``reference`` on the card, F=1 bitwise
     ``decide``, wall, K1 launches, a traced decide, K1 on its first
     pass against its plain version; (c) ``decide_race`` from F0=8 to
     F_max=64 on the mirror: its winner that of the one-shot F=64 fan
     (k=2048), members, rungs, both walls; (d) five Polaris cycles of
     ``SchedTwin(ensemble=8)`` (k=256); (e) ``fan_grid`` over S=1 of
     phase 12's traces x F=16 x the k=32 pool (512 forks; noise 0.3,
     burst 0.2, failures 0.1 over 4 domains; ``cvar:0.9:score``):
     bitwise ``replay_grid(materialize_fan(...))``, ``cuda`` bitwise
     ``reference`` on an S=1 x F=8 slice, wall, iterations, host reads,
     a block under ``set_sync_debug_mode("error")``, four traced blocks,
     K1 on a pass (k=512) against its plain version; (f)
     ``race_grid`` from F0=4 to F_max=16 over (e)'s scenarios: winners
     those of (e)'s fan, members, rungs, ``stopped``, walls;
     (g) ``twin_loop --fan 8 --race``, ``--ensemble 4`` and
     ``--replay-grid 4 --fan 8 --prune`` print the same report on cuda
     and cpu.  Each path runs with K1's count set to 0 before it and
     read after; a path that never launched K1 fails the phase;
 14. learning, checkpoints, snapshots and chaos, K1 the pass of every
     path: (a) ``prng.sin_f32`` (glibc's ``sinf``, the burst warp's)
     on the card against the CPU over 2**20 + 2**17 arguments in ±1e5
     rad and around 120 rad, and phase 13 (e)'s burst fan materialized
     on cuda against cpu: bitwise; (b) ``learn.train`` at Polaris scale
     (CEM over wfp, population 16, 2 generations, goal ``score``, on 4
     training and 2 held-out traces of phase 12's family, J=1024: gen 0
     evaluates 4 x 18 and 2 x 18 forks), checkpointed every generation
     under ``build/``: per generation the wall, each grid's wall, K1
     launches and host reads and the history line; gen 0's grid on one
     scenario cuda bitwise ``reference``; four traced blocks of gen 0's
     training grid, and K1 on the next pass (k=72) against its plain
     version with its time and bound; a resume from the step-1
     checkpoint alone bitwise the uninterrupted run (θ, history,
     held-out cost); ``trained:<dir>,
     paper`` deploying the in-memory θ's held-out costs bitwise; (c)
     five ``SchedTwin(ensemble=8)`` Polaris cycles against two, a
     snapshot, and three on a fresh twin restored from it: qrun sets,
     winners, costs and the key bitwise, with save and restore walls
     and bytes on disk; (d) ``twin_loop --chaos``, the same killed after
     cycle 20 and resumed (its metric table, what-if breakdown and
     policy mix those of the uninterrupted run), ``--train 2`` and
     ``--pool trained:<dir>,paper``, on cuda and cpu: the same reports;
 15. the fleet engine (``core.whatif.sharded_*``) at Polaris scale, K1
     the pass of every path: (a) ``replay_grid`` over 256 traces of
     phase 12's family x the k=32 DRAS pool (8,192 forks, 8.4M job
     slots, ``score``) against ``sharded_replay_grid(make_fleet_mesh(),
     block_size=64)`` (4 blocks of 2,048 forks) at prefetch depths 2 and
     0: every field bitwise; walls, peak device memory
     (``max_memory_allocated``, reset before each run), K1 launches and
     host reads of each; K1 on the 501st pass of the one-shot grid
     (k=8,192) and of the stream's first block (k=2,048) bitwise its
     plain version, with its time and bound; the first 16 scenarios
     replayed by the ``reference`` backend on the card bitwise the
     stream's rows; the one-shot rows of those 16 scenarios scored alone
     against the full grid's metrics; (b) a mesh of cuda:0 named twice
     over those 16 scenarios in blocks of 8: bitwise the one-shot rows; (c) ``sharded_fan_grid`` over phase 13 (e)'s fan in
     blocks of 4 pseudo-scenarios bitwise phase 13 (e)'s ``fan_grid``,
     and ``sharded_race_grid`` F0=4 -> 16 in blocks of 8 window rows:
     the winners, rungs and members of phase 13 (f)'s ``race_grid``; (d)
     ``sharded_whatif`` on phase 4's mirror, one shard and cuda:0 named twice, bitwise
     ``decide``, and ``decide_legacy_vmap`` there: the same winner,
     qrun set and deadlocks, costs within rtol 1e-5; (e) ``twin_loop --replay-grid 8`` (also ``--fan 8`` and
     ``--fan 8 --race``) with ``--shard 0 --block-size 4 --prefetch 2``
     on cuda and cpu: the report of the grid without those flags; (f)
     the three examples (``repro_torch.examples``) on cuda, each in a
     process of its own, side by side: each exits 0; its wall and K1
     launches.  Each path runs with K1's count set to 0
     before it and read after; a path that never launched K1 fails the
     phase;
 16. the moe, vlm and encdec families at published widths (random bf16
     weights, seed 0), K4 in their prefills, each model freed before the
     next: (a) olmoe-1b-7b through ``ServingEngine`` as phases 9-11 (4
     requests of 128-1024 tokens, 2 slots, max_seq 1280, 8 new tokens;
     K4 16 launches a prefill, none a decode step), then its two MoE
     dispatches on the hidden states a 1024-token prefill hands layer
     0's MoE (``moe_dropped`` and aux terms equal, GShard within 3% of
     gather with C17's summed gates, the times); (b)
     deepseek-v2-lite-16b, cut to 14 of its 27 layers, the same way (MLA
     prefill runs the plain
     attention: K4 0 launches), then MLA's absorbed decode at S=512
     against the decompressed prefill of 513; (c) internvl2-76b cut to 8
     of its 80 layers: 256 random patch embeddings and 2 prompts of
     128-768 tokens through ``api.prefill`` and 8 ``api.decode_step``s
     each (K4 8 launches a prefill); (d) whisper-small through
     ``ServingEngine`` (4 requests of 64-448 tokens, 2 slots, max_seq
     512; K4 36 launches a prefill: encoder, decoder self and cross);
     (e) K4 at whisper's audio shapes (B=1, H=12, D=64, bf16,
     non-causal: S=1500, and Sq=448 against Sk=1500) against its plain
     version, timed in turns with SDPA; (f)
     ``repro_torch.examples.serve_twin`` on cuda and cpu: the same
     report.  A MoE model's first-token logits past ``LOGIT_TOL`` pass
     only where the prefill's routers first part at a near tie (ranks k
     and k + 1 within 1% of each other) and the kernels' prefill, rerun
     with every router forced to the plain run's experts, comes back
     within ``LOGIT_TOL``; both are printed;
 17. LM training on the card (no kernel on its path: none has a
     backward, and K2-K4's counts must not move): (a) llama3.2-1b at
     published widths and full depth (1,235,814,400 parameters drawn on
     the card as the JAX package draws them, bf16, f32 moments), global
     batch 8 x 1024 tokens in 2 microbatches, AdamW peak 3e-3, warmup 1,
     8 steps: 8 steps on fresh ``SyntheticLM`` batches (finite losses;
     wall a step, tokens/s, peak memory, the share of dense bf16 peak, a
     traced step), then 8 steps on one batch repeated from the same
     weights (the mean loss of steps 7-8 below step 1's); (b) one f32
     step of llama3.2-1b cut to 2 of 16 layers, batch 2 x 256, on cuda
     and on cpu from the same weights: loss and grad norm within rtol
     1e-5, gradients and moments within 1e-4 of their tensor's max |x|,
     parameters within 1e-4 of max |p| where |g| >= 1e-3 max |g| and
     within 2·lr anywhere; (c) one bf16 step of olmoe-1b-7b and
     deepseek-v2-lite-16b (2 layers), rwkv6-7b (2 of 32 layers, 256
     tokens), recurrentgemma-2b (one pattern period, 3 of 26 layers),
     internvl2-76b (2 of 80 layers, 256 zero patches) and whisper-small
     (whole, 1500 zero frames), each freed before the next: finite loss,
     grad norm finite and > 0, the MoE's aux terms in the total; (d)
     ``quantize`` on the card bitwise the CPU's on (b)'s cut model's
     gradients, and one ``--compress`` step; (e) ``python -m
     repro_torch.launch.train --arch llama3.2-1b --smoke --steps 20
     --log-every 5`` on cuda and cpu (losses within 2e-3, grad norms
     within 5e-3, learning rates equal), checkpointed at steps 10 and 20
     under ``build/``, relaunched from step 10: the uninterrupted run's
     lines for steps 15 and 20.  To make room for it (and for drawing
     the reference's weights on the card), phases 10 and 16 (b) serve
     rwkv6-7b and deepseek-v2-lite-16b at half depth, and the Polaris
     trace family that phases 12-15 replay holds 500 jobs a trace (was
     1,000): about 1,000 host steps a replay instead of 2,000.
 18. the one-GPU dry run (``repro_torch.launch.dryrun``) held against
     the card: (a) ``run_cell`` on meta for 13 cells, a prefill and a
     decode cell a family plus (b)'s, a record line each (no train
     cell: (c) runs one, ``dryrun --all`` the rest); (b) llama3.2-1b
     prefill_32k at batch 8 and decode_32k at batch 32,
     recurrentgemma-2b prefill_32k at batch 1 and rwkv6-7b prefill_32k
     at batch 1 and 16 of 32 layers, each on meta and then for real on
     zero weights (K2/K3/K4 launches equal to the meta run's kernel
     calls; the counter around the real call gives meta's FLOPs
     exactly; ``max_memory_allocated()`` above the inputs within 5% +
     256 MiB of meta's peak above its inputs; the wall, outside the
     counter, against the roofline's max(Tc, Tm)); (c) phase 17 (a)'s
     configuration on meta against phase 17's measured peak above its
     state and a counted step on the card (equal FLOPs, no kernel).

The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.

On request, before those two lines:

  --parent DIR   K1 (the drain's first pass and the mean over the
                 captured passes), K2's ``rglru`` (S=2048) and K3
                 (S=1000) built from the sources of the checkout at DIR
                 (e.g. ``git archive`` of the parent commit, unpacked
                 under ``build/``) against this tree's, on the same
                 inputs, timed in turns: parent, change, change, parent;
  --k1-phases    K1's time phase by phase in clocks: a copy of each
                 source (this tree's; the parent's too with --parent)
                 with clock64() stamps behind a barrier at each
                 ``// ---- `` phase comment, built under ``build/``, run
                 on the captured drain passes;
  --k2-phases    K2's chain in clocks a step (its wait for a full tile,
                 and its work) at B=1, S=2048, W=2560, both entries, from
                 copies of this tree's source with clock64() stamps
                 around the chain warp's loop, built under ``build/``:
                 as it is, with the workers only passing the tile
                 barriers (no loads, gates or stores), and without the
                 TMA store of the output.
"""
from __future__ import annotations

import dataclasses
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
# H100 SXM data-sheet rates: HBM3 bytes/s, non-tensor 32-bit ops/s and
# dense bf16 FLOP/s (the dry run's roofline divides by the same)
from repro_torch.launch.cost import HBM_BW as MEM_RATE  # noqa: E402
from repro_torch.launch.cost import OP_RATE  # noqa: E402
from repro_torch.launch.cost import PEAK_FLOPS_BF16 as BF16_PEAK  # noqa: E402

K1 = dict(name="policy_eval_pass_batched", route="cuda",
          source="src/repro_torch/csrc/policy_eval.cu",
          replaces="src/repro/kernels/policy_eval.py:65")
K1S = dict(name="policy_eval_pass", route="cuda",
           source="src/repro_torch/csrc/policy_eval.cu",
           replaces="src/repro/kernels/policy_eval.py:176")
K2 = dict(name="rglru", route="cuda", source="src/repro_torch/csrc/rglru.cu",
          replaces="src/repro/kernels/rglru.py:31")
K3 = dict(name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
          replaces="src/repro/kernels/wkv6.py:34")
K4 = dict(name="flash_attention", route="cuda",
          source="src/repro_torch/csrc/flash_attention.cu",
          replaces="src/repro/kernels/flash_attention.py:37")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def build_kernels():
    """Build every kernel with ptxas's report; returns {name: log}."""
    from repro_torch.kernels import build
    done = build.build(force=True, extra_flags=("-Xptxas", "-v"))
    for name, (seconds, log) in done.items():
        print(f"[build] {name}: nvcc {seconds:.2f} s "
              f"-> {build.library_path(name).name}")
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    return {name: log for name, (_, log) in done.items()}


def ptxas_by_head_dim(log, kernel="flash_wgmma_kernel"):
    """{D: (registers, spill stores, spill loads)} of ``kernel``'s
    instantiations in ptxas's ``-v`` report."""
    import re
    rows, d = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '.*?" + kernel + r"ILi(\d+)E", line)
        if m:
            d = int(m.group(1))
            rows[d] = [0, 0, 0]
            continue
        if "entry function" in line:
            d = None
        if d is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[d][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[d][0] = int(m.group(1))
    return {d: tuple(r) for d, r in rows.items()}


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


def make_twin(engine, on_qrun, **twin_kw):
    from repro_torch.core.events import EventBus
    from repro_torch.core.twin import SchedTwin
    bus = EventBus()
    twin = SchedTwin(bus=bus, qrun=on_qrun, total_nodes=POLARIS_NODES,
                     max_jobs=POLARIS_SLOTS, pool=DRAS_POOL,
                     objective="score", engine=engine, **twin_kw)
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


def bound(nbytes, flops, op_rate):
    """The least time for the work: bytes over the HBM rate against
    operations over ``op_rate``; returns (ms, what bounds it)."""
    bytes_ms = nbytes / MEM_RATE * 1e3
    ops_ms = flops / op_rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def k1_bound_ms(torch, args):
    """Least time for one pass on these inputs: bytes (each input read
    once, each output written once) over the HBM rate against the
    lexicographic count's compare-adds over the non-tensor rate."""
    k, J = args[0].shape
    nbytes = k * J * (4 * 5) + k * (4 + 4) + 4 + k * J * 1 + k * 4
    return bound(nbytes, pass_ops(torch, args), OP_RATE)


def pass_ops(torch, args):
    """The pass's compare-adds on these (k, J) inputs: 2 per pair of the
    running and pass-1-started jobs of each fork that has a head."""
    from repro_torch.core.state import QUEUED, RUNNING
    order, state, nodes, est, end_t, free0, now, limit = args
    J = order.shape[1]
    idx = order.long()
    ranks = torch.arange(J, device=order.device)
    rank_hi = J if limit is None else limit.long()
    q_rank = torch.gather(state == QUEUED, 1, idx) & (ranks < rank_hi)
    need = torch.cumsum(torch.where(q_rank, torch.gather(nodes, 1, idx), 0),
                        1)
    started = q_rank & (need <= free0[:, None])
    has_head = (q_rank & ~started).any(1)
    running = (state == RUNNING).sum(1) + started.sum(1)
    return int((2 * running.long() ** 2 * has_head).sum())


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
    drain_ms = time_ms(torch, drain_launches(torch, pe, drain_inputs),
                       20) / len(drain_inputs)
    bound, bound_by = k1_bound_ms(torch, first)
    print(f"[k1] first pass of the drain (k=32, J={POLARIS_SLOTS}): kernel "
          f"{ms * 1e3:.2f} / {ms2 * 1e3:.2f} us per launch (back-to-back "
          f"launches of the C entry point), {wrapper_ms * 1e3:.2f} us per "
          f"call through the Python wrapper, plain {plain_ms:.3f} ms, "
          f"bound {bound * 1e3:.3f} us ({bound_by}; kernel at "
          f"{100 * bound / min(ms, ms2):.2f}% of it); mean over the "
          f"{len(drain_inputs)} captured drain passes "
          f"{drain_ms * 1e3:.2f} us per launch")
    print(f"[k1] captured drain passes, per fork: {pass_counts_line(torch, drain_inputs)}")
    return dict(max_abs_err=float(worst), ms=min(ms, ms2),
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                drain_mean_ms=drain_ms), drain_inputs


def drain_launches(torch, pe, inputs, fn=None):
    """One launch of K1 (or ``fn``, a library's C entry of the same
    signature) on each of ``inputs`` in turn."""
    launches = [raw_launch(torch, pe, a, fn=fn) for a in inputs]

    def run():
        for launch in launches:
            launch()
    return run


def pass_counts(torch, args):
    """Per fork of one pass: R, the running and pass-1-started jobs with
    a finite end, and n_cand, the ranks the backfill walk must decide
    (queued after the head and below the limit, not started, fitting
    the state before the walk).  -1 for both in a fork with no head.
    Derived from the plain pass's rules."""
    from repro_torch.core.backfill import _pass
    from repro_torch.core.state import QUEUED, RUNNING
    order, state, nodes, est, end_t, free0, now, limit = args
    k, J = order.shape
    idx = order.long()
    ranks = torch.arange(J, device=order.device)
    q_rank = torch.gather(state == QUEUED, 1, idx) & (
        ranks < (J if limit is None else int(limit)))
    nd_rank = torch.where(q_rank, torch.gather(nodes, 1, idx), 0)
    need = torch.cumsum(nd_rank, 1)
    started = q_rank & (need <= free0[:, None])
    blocked = q_rank & ~started
    has_head = blocked.any(1)
    head_rank = torch.argmax(blocked.to(torch.int8), 1)
    free1 = free0 - torch.where(started, nd_rank, 0).sum(1)
    _, _, _, shadow = _pass(*args)
    started_slot = torch.zeros_like(started).scatter(1, idx, started)
    end_eff = torch.where(started_slot, now[:, None] + est,
                          torch.where(state == RUNNING, end_t, torch.inf))
    finite = end_eff < torch.inf
    R = finite.sum(1)
    # extra: cum over the (end, slot) order at the first feasible job
    srt, perm = torch.sort(end_eff, dim=1, stable=True)
    cum = free1[:, None] + torch.cumsum(torch.gather(
        torch.where(finite, nodes, 0), 1, perm), 1)
    head_nodes = torch.gather(nd_rank, 1, head_rank[:, None])[:, 0]
    feas = (cum >= head_nodes[:, None]) & torch.isfinite(srt)
    cum_first = torch.where(feas, cum, 2 ** 31).amin(1)
    extra = torch.where(feas.any(1), cum_first - head_nodes, 0)
    cond_a = now[:, None] + torch.gather(est, 1, idx) <= shadow[:, None]
    cand = (blocked & (ranks > head_rank[:, None]) & (nd_rank <= free1[:, None])
            & (cond_a | (nd_rank <= extra[:, None])))
    n_cand = cand.sum(1)
    return (torch.where(has_head, R, -1).tolist(),
            torch.where(has_head, n_cand, -1).tolist())


def pass_counts_line(torch, inputs):
    import numpy as np
    rs, cs = [], []
    for a in inputs:
        r, c = pass_counts(torch, a)
        rs += [x for x in r if x >= 0]
        cs += [x for x in c if x >= 0]
    if not rs:
        return "no fork has a head"
    q = lambda v: (f"mean {np.mean(v):.1f}, p50 {np.median(v):.0f}, "  # noqa: E731
                   f"p90 {np.percentile(v, 90):.0f}, max {max(v)}")
    return (f"{len(rs)} forks with a head of {len(inputs) * inputs[0][0].shape[0]}: "
            f"R {q(rs)}; n_cand {q(cs)}")


def raw_launch(torch, pe, args, entry="policy_eval_pass_batched", fn=None,
               out=None):
    """K1 (or K1', ``entry="policy_eval_pass"``; or ``fn``, another
    library's C entry of the same signature) launched straight through
    its C entry point on fixed buffers (``out``: started, free), so that
    back-to-back launches time the kernel, not the wrapper's checks and
    allocations."""
    k, J = args[0].shape
    started, free = out if out is not None else (
        torch.empty((k, J), dtype=torch.bool, device="cuda"),
        torch.empty((k,), dtype=torch.int32, device="cuda"))
    fn = fn or pe._kernel(entry)
    ptrs = [None if a is None else a.data_ptr() for a in args] + [
        started.data_ptr(), free.data_ptr()]
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
def polaris_cycles(torch, engine, pe, tag="[polaris]", after_cycle=None,
                   **twin_kw):
    """Five decision cycles through the normal entry point: events on the
    bus, ``SchedTwin.pump()`` (a twin built with ``twin_kw``, e.g.
    ``ensemble=8``).  The qrun callback stands in for the scheduler: it
    publishes RUNJOB for every started job.  ``after_cycle(cycle, twin,
    make)``, if given, may return the twin to go on with (``make()``
    builds a fresh one on the same bus).  Returns K1's launches, the
    mirrors, the cycle walls and the last twin."""
    from repro_torch.core.events import Event, EventKind
    pending = []

    def on_qrun(job_ids, t):
        pending.extend(Event(EventKind.RUNJOB, t, j) for j in job_ids)

    bus, twin = make_twin(engine, on_qrun, **twin_kw)

    def make():
        from repro_torch.core.twin import SchedTwin
        return SchedTwin(bus=bus, qrun=on_qrun, total_nodes=POLARIS_NODES,
                         max_jobs=POLARIS_SLOTS, pool=DRAS_POOL,
                         objective="score", engine=engine, **twin_kw)
    trace, events, n_run = polaris_backlog()
    for ev in events:
        bus.publish(ev)
    rows, mirrors = [], []
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
        mirrors.append(twin.state)
        rec = twin.telemetry.cycles[-1]
        assert len(twin.telemetry.cycles) == n_before + 1
        jobs = twin.state.jobs
        n_q = int((jobs.state == 1).sum())
        n_r = int((jobs.state == 2).sum())
        rows.append(rec.wall_seconds)
        print(f"{tag} cycle {cycle}: {rec.wall_seconds * 1e3:.1f} ms, "
              f"{pe.LAUNCHES - before} lock-step drain iterations "
              f"(= K1 launches), running {n_r} queued {n_q}, winner "
              f"{rec.policy}, started {rec.n_started}"
              + (f", {rec.fan_size} members" if rec.fan_size > 1 else ""))
        if not all(math.isfinite(c) for c in rec.costs.values()):
            raise SystemExit(f"{tag} cycle {cycle}: non-finite costs")
        if after_cycle is not None:
            twin = after_cycle(cycle, twin, make)
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit(f"{tag} the main path never launched K1")
    forks = ("k=32" if twin_kw.get("ensemble", 1) <= 1 else
             f"k=32 x {twin_kw['ensemble']} members = "
             f"{32 * twin_kw['ensemble']} forks")
    print(f"{tag} {POLARIS_CYCLES} cycles, {len(trace)} jobs "
          f"({n_run} started at ingest) on {POLARIS_NODES} nodes, "
          f"J={POLARIS_SLOTS}, {forks}: wall mean "
          f"{statistics.mean(rows) * 1e3:.1f} ms, p50 "
          f"{statistics.median(rows) * 1e3:.1f} ms; K1 launches {launches}")
    return launches, mirrors, rows, twin


# ---------------------------------------------------------------- phase 5
def shared_passes(torch, k, J, seed, collide):
    """K1' inputs at shape (k, J): the first fork's rows of
    ``synthetic_passes`` shared by all k, each fork with its own
    queued-first order."""
    import numpy as np
    from repro_torch.core.state import QUEUED
    order, state, nodes, est, end, free0, now, limit = synthetic_passes(
        torch, k, J, seed, collide)
    rng = np.random.default_rng(seed + 1000)
    queued = (state[0] == QUEUED).cpu().numpy()
    keys = np.where(queued, rng.random((k, J)), np.inf)
    order = torch.from_numpy(np.argsort(keys, axis=1, kind="stable").astype(
        np.int32)).cuda()
    limit = torch.tensor([int(queued.sum())], dtype=torch.int32,
                         device="cuda")
    return (order, state[0].contiguous(), nodes[0].contiguous(),
            est[0].contiguous(), end[0].contiguous(), free0[:1].clone(),
            now[:1].clone(), limit)


def check_k1_shared(torch, snapshot, mirrors):
    """K1' through its entry point, ``ops.twin_schedule_pass``, on each
    Polaris mirror of phase 4 under the k=32 DRAS pool (its launches on
    that path), then on forced collisions; each bitwise against its
    plain version; then its time on the first mirror's inputs."""
    from repro_torch.core.backfill import priority_order
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.state import RUNNING
    from repro_torch.kernels import ops
    from repro_torch.kernels import policy_eval as pe
    pool = parse_pool(DRAS_POOL).spec.to("cuda")
    states = [snapshot.to("cuda")] + [m.to("cuda") for m in mirrors]
    pe.SHARED_LAUNCHES = 0
    outs = [ops.twin_schedule_pass(st, pool) for st in states]
    torch.cuda.synchronize()
    launches = pe.SHARED_LAUNCHES
    if launches != len(states):
        raise SystemExit(f"[k1'] {launches} launches for {len(states)} "
                         f"snapshots")
    cases = []
    for i, st in enumerate(states):
        jobs = st.jobs
        args = (priority_order(st, pool), jobs.state, jobs.nodes,
                jobs.est_runtime,
                torch.where(jobs.state == RUNNING, jobs.end_t, torch.inf),
                st.free_nodes.reshape(1), st.now.reshape(1), None)
        cases.append((f"Polaris mirror {i}", args, outs[i]))
    for seed in range(4):
        args = shared_passes(torch, 32, POLARIS_SLOTS, seed, True)
        cases.append((f"collide k=32 J=1024 seed={seed}", args,
                      pe.policy_eval_pass(*args)))
    args = shared_passes(torch, 8, pe.MAX_J, 7, True)
    cases.append(("collide k=8 J=4096", args, pe.policy_eval_pass(*args)))
    for name, args, (s_k, f_k) in cases:
        s_p, f_p = pe.shared_pass_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(f_k, f_p)):
            raise SystemExit(f"[k1'] MISMATCH on {name}")
    print(f"[k1'] twin_schedule_pass on {len(states)} Polaris snapshots "
          f"(k=32, J={POLARIS_SLOTS}; {int(outs[0][0].sum())} starts on "
          f"the first) and {len(cases) - len(states)} collision inputs: "
          f"started and free bitwise equal to the plain version "
          f"(tolerance: none); K1' launches on the path {launches}")
    first = cases[0][1]
    launch = raw_launch(torch, pe, first, entry="policy_eval_pass")
    ms = time_ms(torch, launch, 500)
    plain_ms = time_ms(torch, lambda: pe.shared_pass_plain(*first), 10)
    ms2 = time_ms(torch, launch, 500)
    k, J = first[0].shape
    nbytes = k * J * 4 + J * 16 + 8 + k * J * 1 + k * 4
    rows = lambda t: t.reshape(1, J).expand(k, J)            # noqa: E731
    expanded = (first[0],) + tuple(rows(t) for t in first[1:5]) + (
        first[5].expand(k), first[6].expand(k), None)
    bnd, by = bound(nbytes, pass_ops(torch, expanded), OP_RATE)
    print(f"[k1'] first Polaris snapshot (k={k}, J={J}): kernel "
          f"{ms * 1e3:.2f} / {ms2 * 1e3:.2f} us per launch, plain "
          f"{plain_ms:.3f} ms, bound {bnd * 1e3:.3f} us ({by})")
    return launches, dict(max_abs_err=0.0, ms=min(ms, ms2),
                          plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                          library_ms=None)


def traced(torch, fn, tag, what, kernel_keys):
    """``fn()`` (which ends in a device read) untraced, then under
    torch.profiler: the device's busy share of the traced wall (the
    union of kernel intervals), the kernel count, the device time of the
    kernels whose name holds each of ``kernel_keys`` and the top six
    kernels.  The traced call follows one warm-up call under the
    profiler: a window's first kernels otherwise go unrecorded.  Where
    a key is a wrapper's (``DEVICE_KERNEL``), the wrapper's own count
    over the traced call is printed beside the profiler's.  Returns
    those numbers (times in us; busy None when the profiler saw no
    device kernel)."""
    if isinstance(kernel_keys, str):
        kernel_keys = (kernel_keys,)
    from torch.profiler import ProfilerActivity, profile, schedule
    wrappers = {key: sys.modules[name] for name, key in DEVICE_KERNEL.items()
                if key in kernel_keys and name in sys.modules}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    untraced = time.perf_counter() - t0
    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(
                     (p.events(), p.key_averages()))) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = {key: m.LAUNCHES for key, m in wrappers.items()}
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {key: m.LAUNCHES - before[key]
                   for key, m in wrappers.items()}
        prof.step()
    events, averages = done[0]
    # the schedule marks each step on the device too ("ProfilerStep#n")
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    elementwise = sum("elementwise" in e.name for e in device)
    out = dict(untraced_us=untraced * 1e6, wall_us=wall * 1e6, busy_us=None,
               kernels=len(spans), by_key={})
    if not spans:
        print(f"{tag} the profiler saw no device kernels: busy share "
              f"not measured")
        return out
    busy, lo, hi = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    out["busy_us"] = busy
    def share(key):
        evs = [e for e in averages if key in e.key]
        total = sum(e.device_time_total for e in evs)
        count = sum(e.count for e in evs)
        out["by_key"][key] = (total, count)
        each = f", {total / count:.2f} us each" if count else ""
        wrapper = (f" (the wrapper counted {counted[key]})" if key in counted
                   else "")
        return f"{key} {total / 1e3:.2f} ms in {count} launches{wrapper}{each}"
    shares = ", ".join(share(key) for key in kernel_keys)
    print(f"{tag} {what}: untraced {untraced * 1e3:.1f} ms; traced "
          f"{wall * 1e3:.1f} ms with {len(spans)} device kernels "
          f"({elementwise} of them PyTorch elementwise kernels), device "
          f"busy {busy / 1e3:.1f} ms ({100.0 * busy / (wall * 1e6):.1f}% "
          f"of the traced wall), of it {shares}")
    top = sorted(averages, key=lambda e: -e.device_time_total)
    for e in [e for e in top if not e.key.startswith(
            ("aten::", "ProfilerStep"))][:6]:
        print(f"{tag}   {e.device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x {e.key[:60]}")
    return out


def profile_cycle(torch, engine, snapshot):
    """One more Polaris-scale decide, untraced then under torch.profiler:
    device busy share, kernels per cycle, K1's share."""
    from repro_torch.core.policies import parse_pool
    pool = parse_pool(DRAS_POOL).spec.to(engine.device)
    traced(torch, lambda: int(engine.decide(snapshot, pool).policy_index),
           "[profile]", "Polaris decide", "pass_kernel")


# ---------------------------------------------------------- phases 5 and 6
def time_median_ms(torch, fn, n, reps=5):
    """Median over ``reps`` runs of ``n`` back-to-back calls, ms per call
    (CUDA events)."""
    return statistics.median(time_ms(torch, fn, n) for _ in range(reps))


def worst_excess(got, want, tol):
    """max |got - want| and whether it stays within atol = rtol = tol."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return err, ok


def sdpa_call(torch, q, k, v, causal, window=0):
    """One PyTorch call computing K4's function, timed as the library
    yardstick only (the port never calls it).  Where the installed torch
    lacks ``enable_gqa``, or a window needs a boolean mask, k/v are
    repeated outside the timed region."""
    F = torch.nn.functional
    group = q.shape[1] // k.shape[1]
    if window:
        s = q.shape[2]
        pos = torch.arange(s, device=q.device)
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)
        kr = k.repeat_interleave(group, 1)
        vr = v.repeat_interleave(group, 1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=mask)
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:
        kr = k.repeat_interleave(group, 1)
        vr = v.repeat_interleave(group, 1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                      is_causal=causal)


def k4_raw_launch(torch, fa, q, k, v, causal, window=0):
    """K4 launched straight through its C entry on fixed buffers, so
    that back-to-back launches time the kernel (and the C entry's tensor
    maps), not the wrapper's checks and allocations."""
    fn = fa._kernel()
    _, args = fa.launch_args(q, k, v, causal=causal, window=window,
                             scale=None)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream) != 0:
            raise SystemExit("[k4] launch failed")
    return launch


def k4_in_turns(torch, kernel, library, n=20):
    """kernel, library, library, kernel: (kernel ms, library ms), each
    the mean of its two turns' medians, and the four turns."""
    turns = [time_median_ms(torch, fn, n)
             for fn in (kernel, library, library, kernel)]
    return ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns)


def check_k4(torch):
    """K4 against full_attention on the card at llama3.2-1b's prefill
    shapes (B=1, Hq=32, Hkv=8, D=64), q/k/v as the model hands them over
    (transposed views of (B, S, H, D) projections).  bf16 causal: kernel
    and SDPA timed in turns."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import full_attention
    cases = [(1000, torch.bfloat16, True), (2048, torch.bfloat16, True),
             (1000, torch.float32, True), (1000, torch.bfloat16, False)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for s, dtype, causal in cases:
        def proj(h):
            return torch.randn((1, s, h, 64), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype).transpose(1, 2)
        q, k, v = proj(32), proj(8), proj(8)
        out = fa.flash_attention(q, k, v, causal=causal)
        ref = full_attention(q, k, v, causal=causal, q_block=512)
        torch.cuda.synchronize()
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        err, ok = worst_excess(out, ref, tol)
        name = (f"S={s} {str(dtype)[6:]} "
                f"{'causal' if causal else 'non-causal'}")
        if not ok or out.dtype != dtype or not torch.isfinite(out).all():
            raise SystemExit(f"[k4] MISMATCH on {name}: max abs err {err} "
                             f"(atol = rtol = {tol})")
        wrapper = time_median_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal), 10)
        plain = time_median_ms(torch, lambda: full_attention(
            q, k, v, causal=causal, q_block=512), 3, reps=3)
        ms, lib, turns = k4_in_turns(
            torch, k4_raw_launch(torch, fa, q, k, v, causal),
            sdpa_call(torch, q.contiguous(), k.contiguous(), v.contiguous(),
                      causal))
        flops, nbytes = fa.work(1, 32, 8, s, s, 64, causal=causal,
                                itemsize=q.element_size())
        bnd, by = bound(nbytes, flops,
                        BF16_PEAK if dtype == torch.bfloat16 else OP_RATE)
        print(f"[k4] {name}: max abs err {err:.3g} (atol = rtol = {tol}); "
              f"kernel {ms * 1e3:.1f} us (turns "
              f"{turns[0] * 1e3:.1f}/{turns[3] * 1e3:.1f}; "
              f"{wrapper * 1e3:.1f} us a wrapper call), sdpa "
              f"{lib * 1e3:.1f} us (turns {turns[1] * 1e3:.1f}/"
              f"{turns[2] * 1e3:.1f}), plain {plain * 1e3:.1f} us, bound "
              f"{bnd * 1e3:.2f} us ({by}; kernel at "
              f"{100 * bnd / ms:.1f}% of it, sdpa {100 * bnd / lib:.1f}%)")
        rows[(s, dtype, causal)] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain, bound_ms=bnd,
                                        bound_by=by, library_ms=lib)
    return rows[(1000, torch.bfloat16, True)]


def check_k4_local(torch):
    """K4 against full_attention at recurrentgemma-2b's local layer
    (B=1, Hq=10, Hkv=1, D=256, bf16, causal): window 2048 at S 2048
    (where it does not bite, so causal SDPA computes the same function)
    and 3072 (SDPA with the window as a boolean mask), and window 100 at
    S 1000 (a row's first key tile can lie wholly outside its window).
    Times, kernel and SDPA in turns: S 2048 and 3072."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import full_attention
    gen = torch.Generator(device="cuda").manual_seed(256)
    rows = {}
    for s, window in ((2048, 2048), (3072, 2048), (1000, 100)):
        def proj(h):
            return torch.randn((1, s, h, 256), generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
        q, k, v = proj(10), proj(1), proj(1)
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        ref = full_attention(q, k, v, causal=True, local_window=window,
                             q_block=512)
        torch.cuda.synchronize()
        err, ok = worst_excess(out, ref, 3e-2)
        name = f"D=256 Hq=10 Hkv=1 S={s} window={window} bf16"
        if not ok or out.dtype != torch.bfloat16 or not torch.isfinite(
                out).all():
            raise SystemExit(f"[k4] MISMATCH on {name}: max abs err {err} "
                             f"(atol = rtol = 3e-2)")
        if s == 1000:
            print(f"[k4] {name}: max abs err {err:.3g} (atol = rtol = "
                  f"3e-2)")
            rows["w100"] = dict(max_abs_err=err)
            continue
        plain = time_median_ms(torch, lambda: full_attention(
            q, k, v, causal=True, local_window=window, q_block=512), 3,
            reps=3)
        ms, lib, turns = k4_in_turns(
            torch, k4_raw_launch(torch, fa, q, k, v, True, window),
            sdpa_call(torch, q.contiguous(), k.contiguous(), v.contiguous(),
                      True, window if s > window else 0))
        # (query, key) pairs inside the causal window, as this data needs
        flops, nbytes = fa.work(1, 10, 1, s, s, 256, causal=True,
                                window=window, itemsize=2)
        bnd, by = bound(nbytes, flops, BF16_PEAK)
        print(f"[k4] {name}: max abs err {err:.3g} (atol = rtol = 3e-2); "
              f"kernel {ms * 1e3:.1f} us (turns {turns[0] * 1e3:.1f}/"
              f"{turns[3] * 1e3:.1f}), sdpa{' (mask)' if s > window else ''}"
              f" {lib * 1e3:.1f} us (turns {turns[1] * 1e3:.1f}/"
              f"{turns[2] * 1e3:.1f}), plain {plain * 1e3:.1f} us, bound "
              f"{bnd * 1e3:.2f} us ({by}, {flops / 1e9:.2f} GFLOP; kernel "
              f"at {100 * bnd / ms:.1f}% of it, sdpa {100 * bnd / lib:.1f}%)")
        rows[s] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                       bound_by=by, library_ms=lib)
    return rows


def report_k4_plan(logs):
    """ptxas's registers, spills and shared memory per head dim of the
    bf16 kernel, beside its plan."""
    from repro_torch.kernels import flash_attention as fa
    rows = ptxas_by_head_dim(logs.get("flash_attention", ""))
    if sorted(rows) != sorted(fa.PLAN):
        raise SystemExit(f"[k4] ptxas reported head dims {sorted(rows)}, "
                         f"expected {sorted(fa.PLAN)}")
    for d, (regs, st, ld) in sorted(rows.items()):
        block_n, stages = fa.PLAN[d]
        print(f"[k4] ptxas D={d}: {regs} registers a thread at entry "
              f"(setmaxnreg: producer 24, consumers 240), spill stores "
              f"{st} B, loads {ld} B; shared memory {fa.smem_bytes(d)} B, "
              f"all dynamic (key tile {block_n}, {stages} stages)")


def k2_gated_inputs(torch, b, s, w, dtype, seed, extreme=False):
    """The gated entry's inputs as recurrentgemma-2b's layer hands them
    over: gate products and biases, lambda, u and the branch, drawn
    normal; with ``extreme``, pre-activations of +-30 (sigmoid exactly 1
    and ~1e-13), -87.5 and -100 (1 + exp past 2^126: the exact
    reciprocal), and lambda of 20.5 and 25 (a exactly 0), -20 and -30 (a
    rounds to 1, 1 - a^2 to 0: the 1e-12 clamp)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    gr, gi, u, br = 2 * n(b, s, w), 2 * n(b, s, w), n(b, s, w), n(b, s, w)
    rb, ib, lam = n(w), n(w), 3 * n(w)
    if extreme:
        gr[..., 0::7], gr[..., 1::7], gr[..., 4::7] = 30.0, -30.0, -87.5
        gi[..., 2::7], gi[..., 3::7], gi[..., 5::7] = 30.0, -30.0, -100.0
        lam[0::5], lam[1::5], lam[2::5], lam[3::5] = 20.5, -20.0, -30.0, 25.0
    return [t.to(dtype) for t in (gr, gi, u, br, rb, ib, lam)]


def k2_raw_launches(torch, rg, a, x, h0, gated):
    """K2's two C entries on fixed output buffers: back-to-back launches
    time the kernel, not the wrapper's checks and allocations."""
    stream = torch.cuda.current_stream().cuda_stream
    fwd, gfn = rg._kernel("rglru_fwd"), rg._kernel("rglru_gated_fwd")
    b, s, w = a.shape
    h_all, hf = torch.empty_like(a), torch.empty_like(h0)
    y = torch.empty_like(gated[0])
    ptrs = [t.data_ptr() for t in gated]
    bf16 = int(gated[0].dtype == torch.bfloat16)

    def launch_fwd():
        if fwd(a.data_ptr(), x.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
               hf.data_ptr(), b, s, w, 1, stream) != 0:
            raise SystemExit("[k2] rglru_fwd launch failed")

    def launch_gated():
        if gfn(*ptrs, None, y.data_ptr(), hf.data_ptr(), b, s, w, bf16, 1,
               stream) != 0:
            raise SystemExit("[k2] rglru_gated_fwd launch failed")
    return launch_fwd, launch_gated


def check_k2(torch):
    """K2's two entries against their plain versions on the card at
    recurrentgemma-2b's prefill shape (B=1, W=2560), S 2048 and 3072:
    ``rglru`` (a = sigmoid, x and h0 normal, f32) against rglru_scan, and
    the gated entry (bf16, as served, with and without the extreme inputs
    of ``k2_gated_inputs``) against rglru_gated_scan; then the gated
    entry at a decode step (B=2, S=1, h0 = 5 N(0, 1), written in place).
    Bitwise: both round every step as the plain versions do.  Times are
    launches of the C entries (TMA path) on fixed buffers, the gated
    entry's on the ordinary inputs: extreme ones send whole threads to
    the exact reciprocal and square root."""
    from repro_torch.kernels import rglru as rg
    from repro_torch.models.blocks_rnn import rglru_gated_scan, rglru_scan
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for s in (2048, 3072):
        shape = (1, s, 2560)
        a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
        x = torch.randn(shape, generator=gen, device="cuda")
        h0 = torch.zeros((1, 2560), device="cuda")
        h_all, h_final = rg.rglru(a, x, h0)
        want_final, want_all = rglru_scan(a, x, h0)
        pairs = [(h_all, want_all), (h_final, want_final)]
        for extreme in (True, False):       # time the ordinary inputs
            gated = k2_gated_inputs(torch, 1, s, 2560, torch.bfloat16,
                                    seed=s, extreme=extreme)
            pairs += zip(rg.rglru_gated(*gated), rglru_gated_scan(*gated))
        torch.cuda.synchronize()
        errs = [float((got.float() - want.float()).abs().max())
                for got, want in pairs]
        if not all(torch.equal(got, want) for got, want in pairs):
            raise SystemExit(f"[k2] MISMATCH at S={s}: max abs err rglru "
                             f"{max(errs[:2])}, gated {max(errs[2:])} "
                             f"(tolerance: none)")
        launch_fwd, launch_gated = k2_raw_launches(torch, rg, a, x, h0, gated)
        ms = time_median_ms(torch, launch_fwd, 20)
        plain = time_median_ms(torch, lambda: rglru_scan(a, x, h0), 1, reps=3)
        ops, nbytes = rg.work(1, s, 2560)
        bnd, by = bound(nbytes, ops, OP_RATE)
        g_ms = time_median_ms(torch, launch_gated, 20)
        g_plain = time_median_ms(torch, lambda: rglru_gated_scan(*gated), 1,
                                 reps=3)
        # gated: four bf16 (B, S, W) inputs and one output, three (W,)
        # vectors, h_final; ~20 operations an element (rg.gated_work)
        g_ops, g_bytes = rg.gated_work(1, s, 2560, 2, with_h0=False)
        g_bnd, g_by = bound(g_bytes, g_ops, OP_RATE)
        print(f"[k2] B=1 S={s} W=2560: rglru (f32) and the gated entry "
              f"(bf16, with and without the extreme inputs) bitwise equal "
              f"to their plain versions (tolerance: none); times on the "
              f"ordinary inputs: rglru {ms * 1e3:.1f} us, "
              f"plain {plain * 1e3:.1f} us, bound {bnd * 1e3:.2f} us ({by}); "
              f"gated {g_ms * 1e3:.1f} us, plain {g_plain * 1e3:.1f} us, "
              f"bound {g_bnd * 1e3:.2f} us ({g_by})")
        rows[s] = (dict(max_abs_err=max(errs[2:]), ms=g_ms, plain_ms=g_plain,
                        bound_ms=g_bnd, bound_by=g_by, library_ms=None),
                   dict(max_abs_err=max(errs[:2]), ms=ms, plain_ms=plain,
                        bound_ms=bnd, bound_by=by, library_ms=None))
    dec = k2_gated_inputs(torch, 2, 1, 2560, torch.bfloat16, seed=7,
                          extreme=True)
    h = 5.0 * torch.randn((2, 2560), generator=gen, device="cuda")
    want_y, want_h = rglru_gated_scan(*dec, h)
    y, got_h = rg.rglru_gated(*dec, h, h_final=h)
    torch.cuda.synchronize()
    if not (got_h is h and torch.equal(y, want_y) and torch.equal(h, want_h)):
        raise SystemExit("[k2] MISMATCH at the decode step (B=2, S=1)")
    wrapper = time_median_ms(torch, lambda: rg.rglru_gated(*dec, h,
                                                           h_final=h), 50)
    print(f"[k2] decode step B=2 S=1 W=2560 bf16, h updated in place: "
          f"bitwise equal to the plain version; {wrapper * 1e3:.1f} us a "
          f"wrapper call (host-bound)")
    gated, fwd = rows[2048]
    return dict(gated, rglru_fwd=fwd,
                s3072=dict(rows[3072][0], rglru_fwd=rows[3072][1]))


def wkv_inputs(torch, s, seed):
    """r, k, v, w, u at rwkv6-7b's prefill shape (B=1, H=64, N=64), f32;
    w = exp(-exp(x)) in (0, 1) as the model makes it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (1, s, 64, 64)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=gen,
                                         device="cuda") - 1.0))
    u = torch.randn((64, 64), generator=gen, device="cuda")
    return r, k, v, w, u


def check_k3(torch):
    """K3 against wkv_scan on the card at rwkv6-7b's prefill shapes."""
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.blocks_rnn import wkv_scan
    rows = {}
    for s in (1000, 1024):
        r, k, v, w, u = wkv_inputs(torch, s, seed=s)
        y, st = wk.wkv6(r, k, v, w, u)
        zero = torch.zeros((1, 64, 64, 64), device="cuda")
        st_ref, y_ref = wkv_scan(zero, r, k, v, w, u)
        torch.cuda.synchronize()
        err_y, ok_y = worst_excess(y, y_ref, 2e-4)
        err_s, ok_s = worst_excess(st, st_ref, 2e-4)
        if not (ok_y and ok_s):
            raise SystemExit(f"[k3] MISMATCH at S={s}: y {err_y}, state "
                             f"{err_s} (atol = rtol = 2e-4)")
        ms = time_median_ms(torch, lambda: wk.wkv6(r, k, v, w, u), 10)
        plain = time_median_ms(torch, lambda: wkv_scan(zero, r, k, v, w, u),
                               1, reps=3)
        ops, nbytes = wk.work(1, s, 64, 64)
        bnd, by = bound(nbytes, ops, OP_RATE)
        print(f"[k3] S={s} f32: max abs err y {err_y:.3g}, state "
              f"{err_s:.3g} (atol = rtol = 2e-4); kernel {ms * 1e3:.1f} us, "
              f"plain {plain * 1e3:.1f} us, bound {bnd * 1e3:.2f} us ({by})")
        rows[s] = dict(max_abs_err=max(err_y, err_s), ms=ms, plain_ms=plain,
                       bound_ms=bnd, bound_by=by, library_ms=None)
    return rows[1000]


# ---------------------------------------------------------- phases 7 and 8
#: The device kernel's name (as the profiler lists it) per wrapper module.
DEVICE_KERNEL = {"repro_torch.kernels.flash_attention": "flash_wgmma_kernel",
                 "repro_torch.kernels.wkv6": "wkv_kernel",
                 "repro_torch.kernels.rglru": "rglru_kernel"}

#: Largest |logit difference| allowed between the kernels' and the plain
#: versions' first-token logits at full width in bf16, and the top-2 gap
#: below which a greedy pick may legitimately flip between the two.
LOGIT_TOL = 0.125
RWKV_LAYERS = 16             # phase 10: rwkv6-7b cut from 32 layers (and
#                              deepseek below from 27) since drawing the
#                              reference's weights on the card and phase
#                              17 took the time


def serve_requests(cfg, n, lo, hi, max_new, seed):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(req_id=r, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new_tokens=max_new) for r in range(n)]


def run_engine(torch, cfg, model, reqs, slots, max_seq, backend):
    """Serve ``reqs`` through ``ServingEngine``; returns (wall s, prefill
    ms per request, decode ms per step, prefills, decode steps).  Prefill
    and decode are timed on the host clock around calls that end in a
    device read."""
    from repro_torch.serve import ServingEngine
    eng = ServingEngine(cfg, model, batch_slots=slots, max_seq=max_seq,
                        device="cuda", backend=backend)
    prefill_ms, decode_ms = [], []

    def timed(fn, out):
        def call(*args):
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return res
        return call

    eng._prefill = timed(eng._prefill, prefill_ms)
    eng._decode = timed(eng._decode, decode_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, statistics.mean(prefill_ms),
            statistics.median(decode_ms), len(prefill_ms), len(decode_ms))


def serve_phase(torch, arch, kernels, n_req, slots, max_seq, lo, hi,
                max_new, min_longest=0, extra=None, layers=None):
    """Serve ``arch`` at full width (random bf16 weights from seed 0;
    ``layers``: the depth, cut from the published one when given)
    with the kernels, then the same requests with the plain versions;
    first-token logits within LOGIT_TOL (for a MoE model, or within it
    once the routers are forced to the plain run's experts, after a
    near tie: ``router_flip``), token streams
    equal or each divergence a near tie.  ``kernels`` maps each kernel's
    wrapper module to its launches per prefill and per decode step; every
    one must launch exactly that many times with the kernels and never
    with the plain versions.  ``extra(cfg, model)`` runs last, before
    the model is freed.  Returns ``{module: launches}`` of the kernels'
    run."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import prefill_batch
    cfg = get_config(arch)
    tag = f"[serve {arch}]"
    if layers is not None:
        print(f"{tag} cut to {layers} of its {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t_model = t0 = time.perf_counter()
    model = api.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag} {sum(p.numel() for p in model.parameters()):,} params "
          f"(bf16) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for backend in ("cuda", "reference"):
        # warm-up (library handles, the kernel's library load), untimed
        warm = serve_requests(cfg, 1, 16, 16, 2, seed=2)
        run_engine(torch, cfg, model, warm, slots, max_seq, backend)
        reqs = serve_requests(cfg, n_req, lo, hi, max_new, seed=1)
        longest = max(len(r.prompt) for r in reqs)
        if longest <= min_longest:
            raise SystemExit(f"{tag} no prompt longer than {min_longest} "
                             f"tokens")
        for kernel in kernels:
            kernel.LAUNCHES = 0
        wall, pre, dec, n_pre, n_dec = run_engine(torch, cfg, model, reqs,
                                                  slots, max_seq, backend)
        launches = {kernel: kernel.LAUNCHES for kernel in kernels}
        toks = sum(len(r.output) for r in reqs)
        counts = ", ".join(f"{k.__name__.split('.')[-1]} launches {n}"
                           for k, n in launches.items())
        print(f"{tag} backend={backend}: {n_req} requests (prompts "
              f"{min(len(r.prompt) for r in reqs)}-{longest} tokens), "
              f"{slots} slots, max_seq {max_seq}: {toks} tokens in "
              f"{wall:.2f} s ({toks / wall:.1f} tok/s); prefill {pre:.1f} ms "
              f"per request, decode {dec:.1f} ms per step ({n_pre} "
              f"prefills, {n_dec} decode steps); {counts}")
        runs[backend] = (reqs, launches, n_pre, n_dec)
    reqs, launches, n_pre, n_dec = runs["cuda"]
    ref_reqs, ref_launches = runs["reference"][:2]
    for kernel, (per_prefill, per_step) in kernels.items():
        want = per_prefill * n_pre + per_step * n_dec
        if launches[kernel] != want or ref_launches[kernel] != 0:
            raise SystemExit(
                f"{tag} {kernel.__name__} launches: {launches[kernel]} "
                f"with the kernels (expected {per_prefill} x {n_pre} "
                f"prefills + {per_step} x {n_dec} decode steps), "
                f"{ref_launches[kernel]} with the plain versions")
    worst = 0.0
    for r in reqs:
        batch = prefill_batch(cfg, torch.as_tensor(
            r.prompt[None].astype("int64"), device="cuda"))
        with torch.inference_mode():
            got, _ = api.prefill(cfg, model, batch, "cuda")
            want, _ = api.prefill(cfg, model, batch, "reference")
        if not torch.isfinite(got).all():
            raise SystemExit(f"{tag} request {r.req_id}: non-finite "
                             f"logits")
        diff = float((got - want).abs().max())
        if diff > LOGIT_TOL:
            router_flip(torch, cfg, model, batch, want,
                        f"{tag} request {r.req_id}: first-token logits "
                        f"differ by {diff:.4g} > {LOGIT_TOL}")
        else:
            worst = max(worst, diff)
    print(f"{tag} first-token logits, kernels vs plain: max abs diff "
          f"{worst:.4g} (tolerance {LOGIT_TOL}) over the requests that "
          f"route alike")
    same = 0
    for r, ref in zip(reqs, ref_reqs):
        if (len(r.output) != max_new or r.first_token_t != ref.first_token_t
                or r.finish_t != ref.finish_t):
            raise SystemExit(f"{tag} request {r.req_id}: lengths or times "
                             f"differ")
        if r.output == ref.output:
            same += 1
            continue
        t = next(i for i, (a, b) in enumerate(zip(r.output, ref.output))
                 if a != b)
        gap = ref.margins[t]
        print(f"{tag} request {r.req_id} diverges at token {t}: kernels "
              f"{r.output[t]}, plain {ref.output[t]}; plain top-2 gap "
              f"{gap:.4g}, kernels' {r.margins[t]:.4g}")
        if gap > LOGIT_TOL:
            raise SystemExit(f"{tag} divergence is not a near tie")
    print(f"{tag} token streams identical for {same} of {len(reqs)} "
          f"requests; first/finish times identical")
    profile_serve(torch, cfg, model, reqs, slots, max_seq, tag,
                  tuple(DEVICE_KERNEL[k.__name__] for k in kernels))
    if extra is not None:
        extra(cfg, model)
    del model
    torch.cuda.empty_cache()
    print(f"{tag} wall {time.perf_counter() - t_model:.1f} s")
    return launches


def profile_serve(torch, cfg, model, reqs, slots, max_seq, tag, keys):
    """One prefill of the longest prompt and one decode step of all
    slots (at that prompt's length), each untraced then traced."""
    from repro_torch.models import api
    from repro_torch.serve.engine import prefill_batch
    longest = max(reqs, key=lambda r: len(r.prompt))
    batch = prefill_batch(cfg, torch.as_tensor(
        longest.prompt[None].astype("int64"), device="cuda"))
    caches = api.init_caches(cfg, slots, max_seq, device="cuda")
    step = {"tokens": torch.zeros((slots, 1), dtype=torch.int64,
                                  device="cuda"),
            "index": len(longest.prompt)}
    with torch.inference_mode():
        traced(torch, lambda: float(api.prefill(cfg, model, batch)[0].sum()),
               tag, f"prefill of {len(longest.prompt)} tokens", keys)
        traced(torch, lambda: float(api.decode_step(cfg, model, caches,
                                                    step)[0].sum()),
               tag, f"decode step of {slots} slots", keys)


# --------------------------------------------------------------- phase 12
REPLAY_SCENARIOS = 8         # S: eight arrival streams of one family
REPLAY_JOBS = 500            # jobs per trace (J = 1024 slots); cut from
#                              1,000 (2,000 replay steps) to 500 (~1,000)
#                              since drawing the reference's weights and
#                              phase 17 took the time: phases 12-15 replay
#                              this family, one host step a K1 launch
REPLAY_GAP = 100.0           # mean inter-arrival, s: offered load ~0.85


def polaris_traces():
    from repro_torch.cluster.workload import poisson_trace, stack_scenarios
    traces = [poisson_trace(REPLAY_JOBS, POLARIS_NODES, REPLAY_GAP, (1, 11),
                            (300.0, 86400.0), seed=s, heavy_tail=True)
              for s in range(REPLAY_SCENARIOS)]
    return traces, stack_scenarios(traces, POLARIS_NODES,
                                   max_jobs=POLARIS_SLOTS)


def offered_load(trace):
    span = trace[-1].submit_t - trace[0].submit_t
    return sum(j.nodes * j.true_runtime for j in trace) / (
        POLARIS_NODES * span), span


def key_parity(torch, states, pool, names):
    """Priority keys of ``pool`` (one row per fork of the batched
    ``states``) computed on the card and on the CPU: the largest
    difference in ulp over queued slots, per family, and the rows whose
    priority order differs."""
    from repro_torch.core.backfill import priority_order
    from repro_torch.core.policies import priority_key_spec
    from repro_torch.core.state import QUEUED

    def on(dev):
        st, pl = states.to(dev), pool.to(dev)
        return (priority_key_spec(st.jobs, st.now, pl).cpu(),
                priority_order(st, pl).cpu())
    (k_dev, o_dev), (k_cpu, o_cpu) = on("cuda"), on("cpu")

    def ordered(k):              # float bits -> integers in float order
        b = k.contiguous().view(torch.int32).long()
        return torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    queued = (states.jobs.state == QUEUED).cpu()
    ulp = torch.where(queued, (ordered(k_dev) - ordered(k_cpu)).abs(), 0)
    fams = {"EXPF": [n == "EXPF" for n in names],
            "expf tau=7200": [n == "expf[tau=7200]" for n in names],
            "WFP": [n == "WFP" or n.startswith("wfp[") for n in names],
            "static lin": [n in ("FCFS", "SJF", "SAF", "LJF", "LXF")
                           for n in names]}
    by_fam = {f: int(ulp[torch.tensor(m)].max()) for f, m in fams.items()}
    differ = [names[i] for i in range(len(names))
              if not torch.equal(o_dev[i], o_cpu[i])]
    return by_fam, differ, int(queued.sum(1).max())


def replay_cli(device):
    """``twin_loop --replay-grid 8`` at the CLI's grid size: its table
    (the wall time cut from the first line) and the line as printed."""
    import contextlib
    import io
    from repro_torch.launch import twin_loop
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        twin_loop.main(["--replay-grid", "8", "--trace", "poisson",
                        "--jobs", "48", "--nodes", "32", "--pool",
                        "extended", "--device", device])
    lines = buf.getvalue().splitlines()
    i = next(n for n, line in enumerate(lines)
             if line.startswith("replay grid:"))
    return [lines[i].rsplit(" in ", 1)[0]] + lines[i + 1:], lines[i]


def replay_phase(torch, pe, snapshot):
    """A Polaris-scale replay grid through ``DrainEngine.replay_grid``:
    S=8 arrival streams of 500 jobs x the k=32 DRAS pool (256 forks,
    J=1024), with K1 as the pass, held bitwise against the reference
    backend on the card and against the port's host emulator on two
    (scenario, policy) pairs; a block of iterations under
    ``set_sync_debug_mode("error")``; C3 (keys on the card against the
    CPU); the replay-grid CLI on cuda and cpu."""
    import numpy as np
    from repro_torch.cluster.emulator import ClusterEmulator
    from repro_torch.core import des
    from repro_torch.core.engine import (DrainEngine, make_order_fn,
                                         replay_inputs)
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.state import QUEUED, map_state
    t_phase = time.perf_counter()
    card = card_line()
    traces, scen = polaris_traces()
    load, span = offered_load(traces[0])
    pool = parse_pool(DRAS_POOL)
    S, P, J = REPLAY_SCENARIOS, len(pool), POLARIS_SLOTS
    cuda = DrainEngine("cuda", device="cuda")
    ref = DrainEngine("reference", device="cuda")
    print(f"[replay] {S} scenarios of {REPLAY_JOBS} jobs on "
          f"{POLARIS_NODES} nodes (J={J}) x the k={P} DRAS pool = {S * P} "
          f"forks, goal score; scenario 0 offers {load:.3f} of the "
          f"cluster over {span / 3600:.1f} h of arrivals")

    def run(engine):
        out = engine.replay_grid(scen, pool.spec, "score")
        out.end_t.cpu()
        return out
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    got = run(cuda)
    cold = time.perf_counter() - t0
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit("[replay] the cuda grid never launched K1")
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    want = run(ref)
    ref_s = time.perf_counter() - t0
    if pe.LAUNCHES:
        raise SystemExit(f"[replay] the reference backend launched K1 "
                         f"{pe.LAUNCHES} times")
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise SystemExit(f"[replay] cuda and reference differ in {name}")
    for name in ("iters", "pass_invocations"):
        if int(getattr(got.result, name)) != int(getattr(want.result, name)):
            raise SystemExit(f"[replay] cuda and reference differ in {name}")
    if got.deadlocked.any() or not torch.isfinite(got.costs).all():
        raise SystemExit("[replay] a fork deadlocked or has no finite cost")
    iters = int(got.result.iters)
    passes = int(got.result.pass_invocations)
    reads = -(-launches // des.REPLAY_BLOCK)
    print(f"[replay] cuda == reference on the card: start_t, end_t, "
          f"deadlocked, events, iters ({iters}), pass_invocations "
          f"({passes}), costs and best identical (tolerance: none); K1 "
          f"launches: cuda {launches}, reference 0; winners "
          f"{[pool.names[int(b)] for b in got.best]}")

    t0 = time.perf_counter()
    run(cuda)
    warm = time.perf_counter() - t0

    # the same replay block by block through des's step: block 2 under
    # sync-debug "error"; a profile of 4 blocks from block 21 (or the
    # last 4); the state of the scenario with the deepest queue at a
    # block's end (for C3)
    states, arrival_t, true_rt, pool_t, _ = replay_inputs(scen, pool.spec,
                                                          "cuda")
    order_fn = make_order_fn(states, pool_t, cuda.plan(pool.spec) * S,
                             torch.isfinite(arrival_t))
    N = des.REPLAY_BLOCK
    w_at = max(1, min(20, reads - 4))
    k1_pass, capture = cuda.pass_fn(), []

    def pass_fn(st, order, limit):     # keeps the inputs of block w_at+1's
        if blk == w_at and not capture:    # first pass
            jobs = st.jobs
            capture.append((order, jobs.state, jobs.nodes, jobs.est_runtime,
                            jobs.end_t, st.free_nodes, st.now, limit))
        return k1_pass(st, order, limit)
    step = des.make_replay_step(arrival_t, true_rt, order_fn, pass_fn)

    def blocks(c, n):
        for _ in range(n * N):
            c = step(c)
        return c
    c, window, deep, blk = des.replay_init(states), None, (-1, None, 0), 0
    while True:
        if blk == 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            c = blocks(c, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        blk += 1
        if blk == w_at:
            window = c
        depth = (c.st.jobs.state == QUEUED).sum(1).reshape(S, P).amax(1)
        s_deep = int(depth.argmax())
        if int(depth[s_deep]) > deep[0]:
            deep = (int(depth[s_deep]), map_state(
                lambda x: x[s_deep * P:(s_deep + 1) * P].clone(), c.st),
                blk * N)
        if not bool(des.replay_cond(c, arrival_t)):
            break
    if not (int(c.it) == iters and torch.equal(c.events, got.result.events)
            and torch.equal(c.st.jobs.start_t,
                            got.result.state.jobs.start_t)):
        raise SystemExit("[replay] the block-by-block run disagrees")
    print(f"[replay] block 2 of the grid ({N} iterations, K1 included) ran "
          f"under torch.cuda.set_sync_debug_mode('error'): no synchronising "
          f"call; the block-by-block run ends as replay_grid does")
    from repro_torch.core.backfill import schedule_pass_batched
    args = capture[0]
    s_k, f_k = pe.policy_eval_pass_batched(*args)
    s_p, f_p = schedule_pass_batched(*args)
    if not (torch.equal(s_k, s_p) and torch.equal(f_k, f_p)):
        raise SystemExit("[replay] K1 and its plain version differ on a "
                         "replay pass")
    launch = raw_launch(torch, pe, args)
    k1_ms = min(time_ms(torch, launch, 500), time_ms(torch, launch, 500))
    plain_ms = time_ms(torch, lambda: schedule_pass_batched(*args), 5)
    bnd, by = k1_bound_ms(torch, args)
    print(f"[replay] K1 on the first pass of block {w_at + 1} (k={S * P}, "
          f"J={J}, limit {int(args[7])}, {int(s_k.sum())} starts): bitwise "
          f"its plain version; {k1_ms * 1e3:.2f} us per launch (CUDA "
          f"events, back-to-back launches of the C entry), plain "
          f"{plain_ms:.3f} ms, bound {bnd * 1e3:.3f} us ({by}) on {card}")
    prof = traced(torch, lambda: bool(des.replay_cond(blocks(window, 4),
                                                      arrival_t)),
                  "[replay]", f"blocks {w_at + 1}-{w_at + 4} of the grid "
                  f"({4 * N} iterations, {S * P} forks)", "pass_kernel")
    k1_us, k1_count = prof["by_key"].get("pass_kernel", (0.0, 0))
    k1_mean = k1_us / k1_count if k1_count else float("nan")
    busy = prof["busy_us"]
    busy_txt = (f"{100.0 * busy / prof['wall_us']:.1f}%" if busy is not None
                else "not measured")
    print(f"[replay] {card}: untraced wall {warm:.3f} s after a warm run "
          f"({cold:.3f} s cold; reference backend {ref_s:.3f} s); {iters} "
          f"iterations, {passes} passes, {launches} K1 launches (one a host "
          f"step: {warm * 1e6 / launches:.1f} us of wall a step), K1 "
          f"{k1_mean:.2f} us a launch by the profiler; {reads} host reads "
          f"({N} iterations a read); blocks {w_at + 1}-{w_at + 4} traced: "
          f"device busy "
          f"{busy_txt} of the traced wall, "
          f"{prof['kernels'] / (4 * N):.1f} kernels per iteration, "
          f"untraced {prof['untraced_us'] / (4 * N):.1f} us per iteration")

    key_pool = parse_pool(DRAS_POOL + ",expf:tau=7200")
    depth, rows, at = deep
    keyed = [("Polaris mirror of phase 4",
              map_state(lambda x: x.expand((len(key_pool),) + x.shape)
                        .contiguous(), snapshot)),
             (f"the deepest replay queue, after {at} iterations,",
              map_state(lambda x: torch.cat([x, x[:1]]), rows))]
    for what, st in keyed:
        by_fam, differ, q = key_parity(torch, st.to("cpu"),
                                       key_pool.spec, key_pool.names)
        print(f"[C3] {what} ({q} queued): largest key difference cuda "
              f"vs cpu in ulp: " + ", ".join(f"{f} {u}"
                                             for f, u in by_fam.items())
              + f"; priority orders that differ: {differ or 'none'}")

    # the port's host emulator on two (scenario, policy) pairs
    for s, p in ((0, pool.names.index("FCFS")), (3, 7 + 12)):
        fork = pool.fork(p)
        t0 = time.perf_counter()
        rep = ClusterEmulator(traces[s], POLARIS_NODES, engine=cuda,
                              max_jobs=J).run(policy_id=fork)
        host_s = time.perf_counter() - t0
        n = len(traces[s])
        for name, arr in (("start_t", rep.start_t), ("end_t", rep.end_t)):
            grid = getattr(got, name)[s, p, :n].cpu().numpy()
            if not np.array_equal(grid, arr.astype(np.float32)):
                raise SystemExit(f"[replay] grid and host emulator differ "
                                 f"in {name}, scenario {s} {pool.names[p]}")
        t0 = time.perf_counter()
        fast = ClusterEmulator(traces[s], POLARIS_NODES, engine=cuda,
                               max_jobs=J).run(policy_id=fork, fast=True)
        fast_s = time.perf_counter() - t0
        if fast.metric_dict() != rep.metric_dict():
            raise SystemExit(f"[replay] run(fast=True) and the host loop "
                             f"report differently, {pool.names[p]}")
        print(f"[replay] scenario {s} x {pool.names[p]}: grid == host "
              f"emulator (start_t, end_t bitwise over {n} jobs; "
              f"{rep.n_events} events); run(fast=True) metric_dict == the "
              f"host loop's; host loop {host_s:.2f} s, fast {fast_s:.2f} s "
              f"on {card}")

    cli_cuda, line = replay_cli("cuda")
    cli_cpu, _ = replay_cli("cpu")
    if cli_cuda != cli_cpu:
        raise SystemExit("[replay-cli] cuda and cpu tables differ")
    print(f"[replay-cli] {line}")
    print(f"[replay-cli] twin_loop --replay-grid 8 (poisson, 48 jobs, 32 "
          f"nodes, extended pool): cuda and cpu print the same "
          f"{len(cli_cuda)}-line table and winners")
    print(f"[replay] phase 12: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, k1_mean_us=k1_mean,
                k1_pass=dict(ms=k1_ms, plain_ms=plain_ms, bound_ms=bnd,
                             bound_by=by))


# --------------------------------------------------------------- phase 13
FAN_DECIDE = dict(n=16, runtime_noise=0.3, failure_prob=0.1)   # k = 512
FAN_GOAL = "p95:avg_wait"
RACE_DECIDE = dict(f_max=64, f0=8)                             # k <= 2048
ENSEMBLE = 8                                                   # k = 256
FAN_GRID_SCENARIOS = 1       # S of phase 12's traces in (e) and (f): cut
#                              from 2 to keep the script near 400 s
FAN_GRID = dict(n=16, runtime_noise=0.3, burst_amplitude=0.2,
                failure_prob=0.1, failure_domains=4)           # S x 512 forks
FAN_GRID_GOAL = "cvar:0.9:score"
FAN_SLICE = 8                # (e): members of the reference slice
RACE_F0 = 4                  # (f): F0 of the race up to (e)'s F=16 (F_max
#                              cut from 32 for time); phase 15 (c) reuses both
FAN_CLI = (["--fan", "8", "--race"], ["--ensemble", "4"],
           ["--replay-grid", "4", "--fan", "8", "--prune"])


def prng_on_card(torch):
    """(a) The fans' key chains on the card against the CPU: seed 0,
    s in 0..7, phi in 0..63, each drawing J=1024 normals, a phase and a
    uniform pair, plus their bits."""
    from repro_torch.core import fan, prng
    s = torch.arange(8).repeat_interleave(64)
    phi = torch.arange(64).repeat(8)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), s), phi)
    gkeys = prng.fold_in(prng.fold_in(prng.PRNGKey(0, device="cuda"),
                                      s.cuda()), phi.cuda())
    cpu = (keys, prng.bits(keys, (POLARIS_SLOTS,))) + fan._member_draws(
        0, s, phi, POLARIS_SLOTS)
    gpu = (gkeys, prng.bits(gkeys, (POLARIS_SLOTS,))) + fan._member_draws(
        0, s.cuda(), phi.cuda(), POLARIS_SLOTS)
    names = ("keys", "bits", "normals/sqrt2", "phase", "uniform pair")
    differ = {n: int((a != b.cpu()).sum()) for n, a, b in zip(names, cpu,
                                                               gpu)}
    scale = fan.lognormal_scale(cpu[2], 0.3)
    differ["lognormal factor"] = int(
        (scale != fan.lognormal_scale(gpu[2], 0.3).cpu()).sum())
    exact = ("keys", "bits", "phase", "uniform pair")
    if any(differ[n] for n in exact):
        raise SystemExit(f"[prng] cuda and cpu draws differ: {differ}")
    print(f"[prng] 512 fold-in chains (seed 0, s 0..7, phi 0..63): keys, "
          f"{512 * POLARIS_SLOTS} bits, phases and uniform pairs bitwise "
          f"the CPU's; normals differing from the CPU's: "
          f"{differ['normals/sqrt2']} of {512 * POLARIS_SLOTS}, lognormal "
          f"factors {differ['lognormal factor']} (bound stated: 0 — every "
          f"operation is IEEE-exact)")
    return differ


def capture_pass(pe, fn, at=0, host=False):
    """Run ``fn()`` with K1's wrapper recording the inputs of its launch
    number ``at`` (the first by default; copied to the host with
    ``host``, so the device's peak memory is not raised); returns (fn's
    result, those inputs, on the card)."""
    real, seen, n = pe.policy_eval_pass_batched, [], [0]

    def spy(*args):
        if n[0] == at:
            seen.append(tuple(None if a is None else
                              (a.cpu() if host else a.clone())
                              for a in args))
        n[0] += 1
        return real(*args)
    pe.policy_eval_pass_batched = spy
    try:
        out = fn()
    finally:
        pe.policy_eval_pass_batched = real
    return out, tuple(None if a is None else a.cuda() for a in seen[0])


def k1_on(torch, pe, args, tag, which="first pass"):
    """K1 on one captured pass of a new path: bitwise its plain version,
    time (C entry, back-to-back), the plain version's time, the bound."""
    from repro_torch.core.backfill import schedule_pass_batched
    s_k, f_k = pe.policy_eval_pass_batched(*args)
    s_p, f_p = schedule_pass_batched(*args)
    if not (torch.equal(s_k, s_p) and torch.equal(f_k, f_p)):
        raise SystemExit(f"{tag} K1 and its plain version differ")
    launch = raw_launch(torch, pe, args)
    ms = min(time_ms(torch, launch, 300), time_ms(torch, launch, 300))
    plain_ms = time_ms(torch, lambda: schedule_pass_batched(*args), 5)
    bnd, by = k1_bound_ms(torch, args)
    k, J = args[0].shape
    print(f"{tag} K1 on the path's {which} (k={k}, J={J}, "
          f"{int(s_k.sum())} starts): bitwise its plain version; "
          f"{ms * 1e3:.2f} us per launch, plain {plain_ms:.3f} ms, bound "
          f"{bnd * 1e3:.3f} us ({by})")
    return dict(k=k, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by)


def same_decision(torch, a, b, what):
    for f in ("policy_index", "costs", "run_mask", "deadlocked",
              "cost_ci", "fan_width"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise SystemExit(f"[fan] {what}: {f} differs")
    for m, n in zip(a.metrics, b.metrics):
        if not torch.equal(m, n):
            raise SystemExit(f"[fan] {what}: metrics differ")


def fan_decide_phase(torch, pe, snapshot, card):
    """(b) ``decide_fan`` on the Polaris mirror, F=16 x k=32 = 512 forks:
    cuda bitwise reference on the card; F=1 bitwise ``decide``; wall,
    K1 launches, a traced decide."""
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.policies import parse_pool
    pool = parse_pool(DRAS_POOL).spec.to("cuda")
    cuda = DrainEngine("cuda", device="cuda")
    ref = DrainEngine("reference", device="cuda")
    spec = FanSpec(**FAN_DECIDE)

    def decide(engine, sp=spec):
        d = engine.decide_fan(snapshot, pool, sp, FAN_GOAL)
        d.run_mask.cpu()
        return d
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    got, first = capture_pass(pe, lambda: decide(cuda))
    cold = time.perf_counter() - t0
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit("[fan] decide_fan never launched K1")
    t0 = time.perf_counter()
    decide(cuda)
    warm = time.perf_counter() - t0
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    want = decide(ref)
    ref_s = time.perf_counter() - t0
    if pe.LAUNCHES:
        raise SystemExit("[fan] the reference backend launched K1")
    same_decision(torch, got, want, "decide_fan cuda vs reference")
    one = dataclasses.replace(spec, n=1)
    d1, d0 = decide(cuda, one), cuda.decide(snapshot, pool, FAN_GOAL)
    for f in ("policy_index", "costs", "run_mask", "deadlocked"):
        if not torch.equal(getattr(d1, f), getattr(d0, f)):
            raise SystemExit(f"[fan] F=1 decide_fan and decide differ in {f}")
    names = parse_pool(DRAS_POOL).names
    ci = got.cost_ci.cpu()
    print(f"[fan] decide_fan on the Polaris mirror, F={spec.n} x k=32 = "
          f"{spec.n * 32} forks, {FAN_GOAL}: cuda == reference on the card "
          f"(winner, costs, CI, spread, qrun set, deadlocks, metrics; "
          f"tolerance: none); F=1 == decide; winner "
          f"{names[int(got.policy_index)]} (CI ±{float(ci[got.policy_index]):.2f}"
          f", spread {float(got.fan_width[got.policy_index]):.2f}), "
          f"{int(got.run_mask.sum())} starts")
    prof = traced(torch, lambda: decide(cuda), "[fan]",
                  f"decide_fan (k={spec.n * 32})", "pass_kernel")
    busy = prof["busy_us"]
    busy_txt = (f"{100.0 * busy / prof['wall_us']:.1f}%" if busy is not None
                else "not measured")
    print(f"[fan] {card}: wall {warm:.3f} s warm ({cold:.3f} s first; "
          f"reference backend {ref_s:.3f} s); {launches} lock-step "
          f"iterations = K1 launches; traced: "
          f"{prof['kernels'] / launches:.1f} kernels an iteration, device "
          f"busy {busy_txt}")
    k1 = k1_on(torch, pe, first, "[fan]")
    return dict(launches=launches, wall=warm, k1=k1)


def race_decide_phase(torch, pe, snapshot, card):
    """(c) ``decide_race`` on the mirror, F_max=64 from F0=8: its winner
    is the F=64 ``decide_fan``'s (k=2048); members, rungs, walls."""
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.race import RaceSpec
    host_pool = parse_pool(DRAS_POOL).spec
    cuda = DrainEngine("cuda", device="cuda")
    fan64 = FanSpec(**{**FAN_DECIDE, "n": RACE_DECIDE["f_max"]})
    race = RaceSpec(fan=fan64, f0=RACE_DECIDE["f0"])

    def run_race():
        d, out = cuda.decide_race(snapshot, host_pool, race, FAN_GOAL)
        d.run_mask.cpu()
        return d, out

    def run_fan():
        full = cuda.decide_fan(snapshot, host_pool, fan64, FAN_GOAL)
        full.run_mask.cpu()
        return full
    # in turns: race, fan, fan, race; launches counted on the first of each
    walls = {"race": [], "fan": []}
    counts = {}
    for name, fn in (("race", run_race), ("fan", run_fan), ("fan", run_fan),
                     ("race", run_race)):
        pe.LAUNCHES = 0
        t0 = time.perf_counter()
        res = fn()
        walls[name].append(time.perf_counter() - t0)
        counts.setdefault(name, (pe.LAUNCHES, res))
    launches, (d, out) = counts["race"]
    fan_launches, full = counts["fan"]
    if launches == 0 or fan_launches == 0:
        raise SystemExit("[race] decide_race or decide_fan never launched K1")
    race_s, fan_s = min(walls["race"]), min(walls["fan"])
    if int(d.policy_index) != int(full.policy_index):
        raise SystemExit("[race] the race's winner is not the F=64 fan's")
    if not torch.equal(d.run_mask, full.run_mask):
        raise SystemExit("[race] the race's qrun set is not the F=64 fan's")
    full_bill = fan64.n * 32
    print(f"[race] decide_race F_max={fan64.n} from F0={race.f0} on the "
          f"Polaris mirror: winner == decide_fan F={fan64.n} (k="
          f"{full_bill}) on the card; {out.members} members of {full_bill} "
          f"({len(out.rungs)} rungs: "
          + ", ".join(f"[{r.lo},{r.hi}) x {len(r.active)}" for r in out.rungs)
          + f"), stopped={out.stopped}, fan_size {out.fan_size}; {card}, "
          f"in turns (race, fan, fan, race): race "
          f"{' / '.join(f'{w:.3f}' for w in walls['race'])} s ({launches} "
          f"K1 launches), one-shot F={fan64.n} fan "
          f"{' / '.join(f'{w:.3f}' for w in walls['fan'])} s "
          f"({fan_launches} K1 launches)")
    return dict(launches=launches, fan64_launches=fan_launches,
                race_s=race_s, fan_s=fan_s, members=out.members,
                full=full_bill)


def fan_grid_phase(torch, pe, card):
    """(e) ``fan_grid`` over S (``FAN_GRID_SCENARIOS``) of phase 12's
    traces x F=16 x the k=32 DRAS pool; (f) ``race_grid`` over them,
    F_max=16 from F0=4."""
    from repro_torch.cluster.workload import stack_scenarios
    from repro_torch.core import des
    from repro_torch.core.engine import (DrainEngine,
                                         _assemble_replay_inputs,
                                         _scenario_arrays, make_order_fn)
    from repro_torch.core.fan import FanSpec, materialize_fan, perturb_window
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.race import RaceSpec, race_grid
    traces, _ = polaris_traces()
    S = FAN_GRID_SCENARIOS
    scen = stack_scenarios(traces[:S], POLARIS_NODES,
                           max_jobs=POLARIS_SLOTS)
    pool = parse_pool(DRAS_POOL)
    P = len(pool)
    spec = FanSpec(**FAN_GRID)
    F = spec.n
    cuda = DrainEngine("cuda", device="cuda")
    ref = DrainEngine("reference", device="cuda")
    print(f"[fan-grid] S={S} of phase 12's scenarios x F={F} x the k={P} "
          f"DRAS pool = {S * F * P} forks, J={POLARIS_SLOTS}, "
          f"{FAN_GRID_GOAL}, noise {spec.runtime_noise}, burst "
          f"{spec.burst_amplitude}, failures {spec.failure_prob} over "
          f"{spec.failure_domains} domains")
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    got = cuda.fan_grid(scen, pool.spec, spec, FAN_GRID_GOAL)
    got.end_t.cpu()
    wall = time.perf_counter() - t0
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit("[fan-grid] fan_grid never launched K1")
    iters = int(got.result.iters)
    reads = -(-launches // des.REPLAY_BLOCK)
    mat = cuda.replay_grid(materialize_fan(scen, spec, device="cuda"),
                           pool.spec, FAN_GRID_GOAL)
    for name in ("start_t", "end_t", "deadlocked", "events"):
        a = getattr(mat, name).reshape(getattr(got, name).shape)
        if not torch.equal(a, getattr(got, name)):
            raise SystemExit(f"[fan-grid] fan_grid and replay_grid of "
                             f"materialize_fan differ in {name}")
    if not torch.equal(mat.costs.reshape(S, F, P), got.member_costs):
        raise SystemExit("[fan-grid] member costs differ from the "
                         "materialized replay's")
    one = dataclasses.replace(scen, **{
        f: getattr(scen, f)[:1] for f in ("submit_t", "nodes",
                                          "est_runtime", "true_runtime",
                                          "valid", "n_jobs",
                                          "total_nodes")})
    part = dataclasses.replace(spec, n=FAN_SLICE)
    pe.LAUNCHES = 0
    a = cuda.fan_grid(one, pool.spec, part, FAN_GRID_GOAL)
    a.end_t.cpu()
    slice_launches = pe.LAUNCHES
    t0 = time.perf_counter()
    b = ref.fan_grid(one, pool.spec, part, FAN_GRID_GOAL)
    b.end_t.cpu()
    ref_s = time.perf_counter() - t0
    if pe.LAUNCHES != slice_launches:
        raise SystemExit("[fan-grid] the reference backend launched K1")
    for name in ("start_t", "end_t", "deadlocked", "events",
                 "member_costs", "costs", "best", "cost_ci", "fan_width"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise SystemExit(f"[fan-grid] cuda and reference differ in "
                             f"{name} on the S=1 x F={part.n} slice")
    if not torch.equal(a.end_t[0], got.end_t[0, :part.n]):
        raise SystemExit(f"[fan-grid] the {part.n}-member slice is not "
                         f"the first members of the {F}-member fan")
    print(f"[fan-grid] fan_grid == replay_grid(materialize_fan) on the card "
          f"(times, deadlocks, events, member costs; tolerance: none); the "
          f"S=1 x F={part.n} slice ({part.n * P} forks): cuda == reference "
          f"in every field and == the full fan's first {part.n} members; "
          f"winners "
          f"{[pool.names[int(i)] for i in got.best]}")

    # block by block: block 2 under sync-debug "error", blocks 3-6 traced
    rows = perturb_window(*_scenario_arrays(scen, cuda.device), spec,
                          torch.arange(S * F, device="cuda"), 0, F, S)
    states, arrival_t, true_rt, pool_t, _ = _assemble_replay_inputs(
        *rows, pool.spec.to("cuda"), P)
    order_fn = make_order_fn(states, pool_t, cuda.plan(pool.spec) * (S * F),
                             torch.isfinite(arrival_t))
    N = des.REPLAY_BLOCK
    step = des.make_replay_step(arrival_t, true_rt, order_fn,
                                cuda.pass_fn())

    def blocks(c, n):
        for _ in range(n * N):
            c = step(c)
        return c
    c = blocks(des.replay_init(states), 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c = blocks(c, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    c, first = capture_pass(pe, lambda: blocks(c, 1))
    prof = traced(torch, lambda: bool(des.replay_cond(blocks(c, 4),
                                                      arrival_t)),
                  "[fan-grid]", f"blocks 4-7 of the fan grid ({4 * N} "
                  f"iterations, {S * F * P} forks)", "pass_kernel")
    busy = prof["busy_us"]
    busy_txt = (f"{100.0 * busy / prof['wall_us']:.1f}%" if busy is not None
                else "not measured")
    print(f"[fan-grid] block 2 ran under set_sync_debug_mode('error'): no "
          f"synchronising call. {card}: wall {wall:.3f} s, {iters} "
          f"iterations, {launches} K1 launches, {reads} host reads ({N} "
          f"iterations a read), {wall * 1e6 / launches:.1f} us of wall a "
          f"step; traced: {prof['kernels'] / (4 * N):.1f} kernels an "
          f"iteration, device busy {busy_txt}; reference backend on the "
          f"{part.n * P}-fork slice {ref_s:.3f} s")
    k1 = k1_on(torch, pe, first, "[fan-grid]")

    # (f) the raced grid up to (e)'s fan: its winners are that fan's
    race = RaceSpec(fan=spec, f0=RACE_F0)
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    out = race_grid(scen, pool.spec, race, FAN_GRID_GOAL, engine=cuda)
    race_s = time.perf_counter() - t0
    race_launches = pe.LAUNCHES
    if race_launches == 0:
        raise SystemExit("[race-grid] race_grid never launched K1")
    best = got.best.cpu().numpy()
    if list(out.best) != list(best):
        raise SystemExit(f"[race-grid] winners {list(out.best)} differ from "
                         f"the F={F} fan's {list(best)}")
    print(f"[race-grid] race_grid F_max={F} from F0={race.f0}: winners == "
          f"(e)'s fan_grid F={F} ({S * F * P} forks); {out.members} members "
          f"of {out.members_full} ("
          + ", ".join(f"[{r.lo},{r.hi}) x {len(r.active)}" for r in out.rungs)
          + f"), stopped={out.stopped}; {card}: race {race_s:.3f} s "
          f"({race_launches} K1 launches), fan F={F} {wall:.3f} s "
          f"({launches} K1 launches)")
    return dict(launches=launches, wall=wall, k1=k1,
                race_launches=race_launches, race_s=race_s,
                members=out.members, members_full=out.members_full,
                fan_out=got, race_out=out)


def fan_cli(device, flags):
    """``twin_loop`` with ``flags`` on the small poisson co-simulation:
    its report without the device's name and the wall-time lines."""
    import contextlib
    import io
    from repro_torch.launch import twin_loop
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        twin_loop.main(["--trace", "poisson", "--jobs", "30", "--nodes",
                        "16", "--seed", "3", "--device", device] + flags)
    keep = []
    for line in buf.getvalue().splitlines()[1:]:
        if line.startswith("cycle latency:"):
            continue
        if line.startswith(("replay grid:", "raced grid:")):
            line = line.rsplit(" in ", 1)[0]
        keep.append(line)
    return keep


def monte_carlo_phase(torch, pe, snapshot, engine):
    """Phase 13: fans, races and ensembles at Polaris scale, K1 as the
    pass of every fork."""
    t_phase = time.perf_counter()
    card = card_line()
    prng_on_card(torch)
    fan = fan_decide_phase(torch, pe, snapshot, card)
    race = race_decide_phase(torch, pe, snapshot, card)
    ens_launches, _, ens_walls, _ = polaris_cycles(torch, engine, pe,
                                                tag="[ensemble]",
                                                ensemble=ENSEMBLE)
    grid = fan_grid_phase(torch, pe, card)
    cli_launches = 0
    for flags in FAN_CLI:
        pe.LAUNCHES = 0
        on_cuda = fan_cli("cuda", flags)
        launches = pe.LAUNCHES
        if launches == 0:
            raise SystemExit(f"[fan-cli] twin_loop {' '.join(flags)} never "
                             f"launched K1")
        cli_launches += launches
        if on_cuda != fan_cli("cpu", flags):
            raise SystemExit(f"[fan-cli] twin_loop {' '.join(flags)}: cuda "
                             f"and cpu reports differ")
        print(f"[fan-cli] twin_loop {' '.join(flags)} (poisson, 30 jobs, 16 "
              f"nodes): cuda and cpu print the same {len(on_cuda)}-line "
              f"report; K1 launches {launches}")
    print(f"[monte-carlo] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches_by_path={
            "fan_decide": fan["launches"], "race_decide": race["launches"],
            "fan64_decide": race["fan64_launches"],
            "ensemble_cycles": ens_launches,
            "fan_grid": grid["launches"],
            "race_grid": grid["race_launches"],
            "fan_race_ensemble_cli": cli_launches},
        fan_pass=fan["k1"], fan_grid_pass=grid["k1"],
        ensemble_wall_mean_ms=statistics.mean(ens_walls) * 1e3,
        fan_grid=(grid["fan_out"], grid["wall"]),
        race_grid=(grid["race_out"], grid["race_s"]))


# --------------------------------------------------------------- phase 14
TRAIN_CFG = dict(family="wfp", strategy="cem", population=16,
                 generations=2, objective="score", seed=0, patience=0)
#                generations cut from 3 for time: the resume starts from
#                the step-1 checkpoint
TRAIN_SPLIT = (4, 2)         # training and held-out Polaris traces
SNAP_AT = 2                  # (c): cycles before the snapshot
WORK = os.path.join(ROOT, "build", "chip_smoke")
RESILIENCE_CLI = ["--trace", "poisson", "--jobs", "30", "--nodes", "16",
                  "--seed", "3"]
TRAIN_CLI = ["--train", "2", "--train-pop", "4", "--train-scenarios", "2",
             "--train-heldout", "1", "--trace", "poisson", "--jobs", "24",
             "--nodes", "16"]


def sin_on_card(torch):
    """(a) ``prng.sin_f32`` on the card against the CPU over 2**20 + 2**17
    arguments spanning ±1e5 rad and the region around 120 rad (both
    reductions), then phase 13 (e)'s burst fan materialized on ``cuda``
    against the same fan materialized on ``cpu``."""
    import numpy as np
    from repro_torch.cluster.workload import stack_scenarios
    from repro_torch.core import prng
    from repro_torch.core.fan import FanSpec, materialize_fan
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.uniform(-1e5, 1e5, 1 << 20), rng.uniform(110.0, 130.0, 1 << 16),
        -rng.uniform(110.0, 130.0, 1 << 16)]).astype(np.float32))
    differ = int((prng.sin_f32(x.cuda()).cpu().view(torch.int32)
                  != prng.sin_f32(x).view(torch.int32)).sum())
    if differ:
        raise SystemExit(f"[sin] {differ} of {x.numel()} sines on the card "
                         f"differ from the CPU's")
    traces, _ = polaris_traces()
    scen = stack_scenarios(traces[:FAN_GRID_SCENARIOS], POLARIS_NODES,
                           max_jobs=POLARIS_SLOTS)
    spec = FanSpec(**FAN_GRID)
    on_card = materialize_fan(scen, spec)
    on_cpu = materialize_fan(scen, spec, device="cpu")
    for f in ("submit_t", "nodes", "est_runtime", "true_runtime", "valid",
              "total_nodes", "n_jobs"):
        if not np.array_equal(getattr(on_card, f), getattr(on_cpu, f)):
            raise SystemExit(f"[sin] the burst fan's {f} differs between "
                             f"cuda and cpu")
    print(f"[sin] glibc's sinf (prng.sin_f32) on {x.numel()} arguments in "
          f"±1e5 rad and ±[110, 130] rad: the card bitwise the CPU (0 "
          f"differ; tolerance: none); phase 13 (e)'s burst fan "
          f"(S={FAN_GRID_SCENARIOS} x F={spec.n}, burst "
          f"{spec.burst_amplitude}) materialized on cuda bitwise on cpu")


def polaris_split():
    """Phase 12's Polaris traces as the trainer's split: 4 training and 2
    held-out days of a Polaris-class backlog, J=1024."""
    import numpy as np
    from repro_torch.cluster.workload import poisson_trace, split_scenarios
    return split_scenarios(
        np.random.default_rng(0),
        lambda r: poisson_trace(REPLAY_JOBS, POLARIS_NODES, REPLAY_GAP,
                                (1, 11), (300.0, 86400.0), rng=r,
                                heavy_tail=True),
        *TRAIN_SPLIT, POLARIS_NODES)


def grid_blocks_traced(torch, pe, engine, scen, pool_spec, tag, what,
                       at=20):
    """Four blocks of a replay grid from block ``at`` under the profiler,
    as phase 12 traces its grid, then K1 on the first pass of the block
    after them against its plain version (``k1_on``).  Returns the
    profile and K1's numbers."""
    from repro_torch.core import des
    from repro_torch.core.engine import make_order_fn, replay_inputs
    S = int(scen.total_nodes.shape[0])
    states, arrival_t, true_rt, pool_t, _ = replay_inputs(scen, pool_spec,
                                                          "cuda")
    plan = engine.plan(pool_spec)
    order_fn = make_order_fn(states, pool_t,
                             plan * S if plan is not None else None,
                             torch.isfinite(arrival_t))
    step = des.make_replay_step(arrival_t, true_rt, order_fn,
                                engine.pass_fn())

    def blocks(c, n):
        for _ in range(n * des.REPLAY_BLOCK):
            c = step(c)
        return c
    c = blocks(des.replay_init(states), at)
    prof = traced(torch, lambda: bool(des.replay_cond(blocks(c, 4),
                                                      arrival_t)),
                  tag, what, "pass_kernel")
    _, first = capture_pass(pe, lambda: blocks(blocks(c, 4), 1))
    return prof, k1_on(torch, pe, first, tag)


def training_phase(torch, pe, card):
    """(b) The learner at Polaris scale (the slice's main path): CEM over
    the wfp family, population 16, two generations on four training
    and two held-out Polaris traces, checkpointed every generation; gen
    0's grid on one scenario cuda bitwise reference; a resume from the
    step-1 checkpoint bitwise the uninterrupted run; ``trained:<dir>``
    deploying the same costs as the in-memory θ."""
    import shutil
    from repro_torch.checkpoint import step_dir
    from repro_torch.cluster.workload import slice_scenarios
    from repro_torch.core import des
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.policies import parse_pool, theta_pool
    from repro_torch.learn import TrainConfig, family_space, train
    from repro_torch.learn.trainer import _gen0_extras
    import numpy as np
    train_scen, heldout = polaris_split()
    cfg = TrainConfig(**TRAIN_CFG)
    cuda = DrainEngine("cuda", device="cuda")
    ref = DrainEngine("reference", device="cuda")
    space = family_space(cfg.family)
    strat = cfg.make_strategy()
    z = strat.ask(strat.init(np.asarray(space.x0, np.float32),
                             np.asarray(space.sigma0, np.float32)))
    names, extra = _gen0_extras(space, cfg)
    gen0 = theta_pool(space.family,
                      np.concatenate([space.decode(z), np.stack(extra)]),
                      [f"cand{i}" for i in range(len(z))] + names)
    S, H, P0 = TRAIN_SPLIT[0], TRAIN_SPLIT[1], len(gen0)
    print(f"[train] {cfg.strategy}/{cfg.family}, population "
          f"{cfg.population}, {cfg.generations} generations, goal "
          f"{cfg.objective}: {S} training and {H} held-out Polaris traces "
          f"({REPLAY_JOBS} jobs, {POLARIS_NODES} nodes, J="
          f"{int(train_scen.submit_t.shape[1])}); gen 0 evaluates {S} x "
          f"{P0} = {S * P0} training forks ({cfg.population} candidates, "
          f"{', '.join(names)}) and {H} x {P0} held-out forks")

    one = slice_scenarios(train_scen, 0, 1)
    pe.LAUNCHES = 0
    got = cuda.replay_grid(one, gen0.spec, cfg.objective)
    got.costs.cpu()
    one_launches = pe.LAUNCHES
    t0 = time.perf_counter()
    want = ref.replay_grid(one, gen0.spec, cfg.objective)
    want.costs.cpu()
    ref_s = time.perf_counter() - t0
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise SystemExit(f"[train] gen 0's grid on scenario 0: cuda and "
                             f"reference differ in {name}")
    if pe.LAUNCHES != one_launches or one_launches == 0:
        raise SystemExit("[train] K1 launched on the reference backend, or "
                         "never on cuda")
    print(f"[train] gen 0's grid on training scenario 0 ({P0} forks): cuda "
          f"== reference on the card (start_t, end_t, deadlocked, events, "
          f"costs, best; tolerance: none); K1 launches {one_launches}; "
          f"reference backend {ref_s:.2f} s")

    # per-grid launches and walls, through the default evaluator
    grids = []
    real = DrainEngine.generation_costs

    def counted(self, *args, **kw):
        before, t0 = pe.LAUNCHES, time.perf_counter()
        out = real(self, *args, **kw)
        out.cpu()
        grids.append((pe.LAUNCHES - before, time.perf_counter() - t0))
        return out
    gens, mark = [], [time.perf_counter(), 0]

    def log(msg):
        if not msg.startswith("gen "):
            return
        now = time.perf_counter()
        mine = grids[mark[1]:]
        mark[1] = len(grids)
        launches = sum(n for n, _ in mine)
        reads = sum(-(-n // des.REPLAY_BLOCK) + 1 for n, _ in mine)
        gens.append(launches)
        print(f"[train] {msg.strip()}: {now - mark[0]:.2f} s, {len(mine)} "
              f"grids ({', '.join(f'{w:.2f} s' for _, w in mine)}), K1 "
              f"launches {launches} (= replay iterations), host reads "
              f"{reads}")
        mark[0] = now
    full_dir = os.path.join(WORK, "train")
    shutil.rmtree(full_dir, ignore_errors=True)
    pe.LAUNCHES = 0
    DrainEngine.generation_costs = counted
    try:
        t0 = time.perf_counter()
        res = train(train_scen, heldout, cfg, engine=cuda,
                    checkpoint_dir=full_dir, log_fn=log)
        wall = time.perf_counter() - t0
    finally:
        DrainEngine.generation_costs = real
    launches = pe.LAUNCHES
    if launches == 0:
        raise SystemExit("[train] training never launched K1")
    if not math.isfinite(res.best_heldout):
        raise SystemExit("[train] no finite held-out cost")
    print(f"[train] {res.generations_run} generations in {wall:.2f} s on "
          f"{card}: incumbent {res.best_desc} ({res.history[-1]['incumbent']}"
          f"), held-out {res.best_heldout:.6g}, train {res.best_train:.6g}; "
          f"K1 launches {launches}")
    prof, k1 = grid_blocks_traced(
        torch, pe, cuda, train_scen, gen0.spec, "[train]",
        f"blocks 21-24 of gen 0's training grid ({S * P0} forks)")
    busy = prof["busy_us"]
    print(f"[train] gen 0's training grid, 4 traced blocks: device busy "
          + (f"{100.0 * busy / prof['wall_us']:.1f}%" if busy is not None
             else "not measured")
          + f" of the traced wall, "
          f"{prof['kernels'] / (4 * des.REPLAY_BLOCK):.1f} kernels per "
          f"iteration")

    part_dir = os.path.join(WORK, "train_resume")
    shutil.rmtree(part_dir, ignore_errors=True)
    shutil.copytree(step_dir(full_dir, 1), step_dir(part_dir, 1))
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    resumed = train(train_scen, heldout, cfg, engine=cuda,
                    checkpoint_dir=part_dir, resume=True)
    resume_s = time.perf_counter() - t0
    resume_launches = pe.LAUNCHES
    if not (np.array_equal(resumed.theta, res.theta)
            and resumed.history == res.history
            and resumed.best_heldout == res.best_heldout):
        raise SystemExit("[train] the resumed run differs from the "
                         "uninterrupted one")
    if resume_launches == 0:
        raise SystemExit("[train] the resumed generation never launched K1")
    print(f"[train] resumed from the step-1 checkpoint alone: generation 2 "
          f"in {resume_s:.2f} s, K1 launches {resume_launches}; θ, history "
          f"and best_heldout bitwise the uninterrupted run's")

    pe.LAUNCHES = 0
    deployed = parse_pool(f"trained:{full_dir},paper")
    via = cuda.replay_grid(heldout, deployed.spec, cfg.objective).costs
    mem = cuda.replay_grid(heldout, res.pool.spec, cfg.objective).costs
    deploy_launches = pe.LAUNCHES
    if not torch.equal(via[:, 0], mem[:, 0]) or deploy_launches == 0:
        raise SystemExit("[train] trained:<dir> deploys other costs than "
                         "the in-memory θ")
    print(f"[train] deploy parity: parse_pool('trained:<dir>,paper') = "
          f"{list(deployed.names)}; its first column of held-out costs "
          f"bitwise the in-memory θ's ({via[:, 0].tolist()}); K1 launches "
          f"{deploy_launches}")
    return dict(launches=launches, one_launches=one_launches,
                resume_launches=resume_launches,
                deploy_launches=deploy_launches, k1=k1)


def snapshot_phase(torch, pe, engine, card):
    """(c) Polaris snapshot and restore: five ``SchedTwin(ensemble=8)``
    cycles uninterrupted, then two, a snapshot, and three more on a
    fresh twin restored from it: the same qrun sets, winners, costs and
    key."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager, step_dir
    root = os.path.join(WORK, "snapshot")
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(root)

    def cycles(twin):
        return [(c.policy, c.costs, c.started_jobs)
                for c in twin.telemetry.cycles]
    pe.LAUNCHES = 0
    _, _, _, full = polaris_cycles(torch, engine, pe, tag="[snapshot]",
                                   ensemble=ENSEMBLE)
    times = {}

    def cut(cycle, twin, make):
        if cycle != SNAP_AT - 1:
            return twin
        t0 = time.perf_counter()
        twin.snapshot(mgr)
        times["save"] = time.perf_counter() - t0
        fresh = make()
        t0 = time.perf_counter()
        step, _ = fresh.restore(mgr)
        times["restore"] = time.perf_counter() - t0
        times["step"] = step
        return fresh
    launches, _, _, resumed = polaris_cycles(
        torch, engine, pe, tag="[snapshot]", after_cycle=cut,
        ensemble=ENSEMBLE)
    if launches == 0:
        raise SystemExit("[snapshot] the restored run never launched K1")
    if cycles(resumed) != cycles(full) or \
            resumed._key.tolist() != full._key.tolist():
        raise SystemExit("[snapshot] the restored twin's decisions differ "
                         "from the uninterrupted run's")
    d = step_dir(root, times["step"])
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"[snapshot] SchedTwin(ensemble={ENSEMBLE}) on the Polaris "
          f"backlog, snapshot after cycle {SNAP_AT}, restored into a fresh "
          f"twin for {POLARIS_CYCLES - SNAP_AT} more: qrun sets, winners, "
          f"costs and the key bitwise the uninterrupted five cycles'; save "
          f"{times['save'] * 1e3:.1f} ms, restore "
          f"{times['restore'] * 1e3:.1f} ms, {size} bytes on disk "
          f"(J={POLARIS_SLOTS}); K1 launches {launches} on {card}")
    return dict(launches=launches, save_s=times["save"],
                restore_s=times["restore"], bytes=size)


def resilience_cli(device, argv, work):
    """``twin_loop`` with ``argv``: its report without the device's name,
    the wall-time lines and the working directory's name, and the
    ``SystemExit`` message if it raised one."""
    import contextlib
    import io
    from repro_torch.launch import twin_loop
    buf, exit_msg = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            twin_loop.main(argv + ["--device", device])
        except SystemExit as e:
            exit_msg = str(e).replace(work, "<dir>")
    lines = [ln.replace(work, "<dir>")
             for ln in buf.getvalue().splitlines()[1:]
             if not ln.startswith(("cycle latency:", "trained "))]
    return lines, exit_msg


def cli_phase(torch, pe):
    """(d) The new CLI modes on cuda and cpu, the same reports: a chaos
    run killed after cycle 20 and resumed (== the uninterrupted chaos
    run), then a small training run and its deployment."""
    import shutil
    runs = {}
    launches = {}
    for device in ("cuda", "cpu"):
        work = os.path.join(WORK, f"cli_{device}")
        shutil.rmtree(work, ignore_errors=True)
        snap, tdir = os.path.join(work, "snap"), os.path.join(work, "pol")
        steps = {
            "chaos": RESILIENCE_CLI + ["--chaos"],
            "kill": RESILIENCE_CLI + ["--chaos", "--snapshot-dir", snap,
                                      "--kill-after-cycle", "20"],
            "resume": RESILIENCE_CLI + ["--chaos", "--snapshot-dir", snap,
                                        "--resume"],
            "train": TRAIN_CLI + ["--train-dir", tdir],
            "deploy": RESILIENCE_CLI + ["--pool", f"trained:{tdir},paper"],
        }
        for name, argv in steps.items():
            pe.LAUNCHES = 0
            runs[device, name] = resilience_cli(device, argv, work)
            if device == "cuda":
                launches[name] = pe.LAUNCHES
    for name in ("chaos", "kill", "resume", "train", "deploy"):
        if runs["cuda", name] != runs["cpu", name]:
            raise SystemExit(f"[resilience-cli] {name}: cuda and cpu "
                             f"reports differ")
        if not launches[name]:
            raise SystemExit(f"[resilience-cli] {name} never launched K1")
    if not (runs["cuda", "kill"][1] or "").startswith(
            "killed after cycle 20"):
        raise SystemExit(f"[resilience-cli] --kill-after-cycle 20 ended "
                         f"with {runs['cuda', 'kill'][1]!r}")
    full, resumed = runs["cuda", "chaos"][0], runs["cuda", "resume"][0]
    # the chaos bus keys its read failures on the process's read calls,
    # which restart with the resumed process (as in the reference), so
    # its read retries and injection counts are left out
    keep = lambda lines: [ln for ln in lines if not ln.startswith(  # noqa
        ("resumed", "bus health", "resilience:"))]
    if keep(resumed) != keep(full) or not any(
            ln.startswith("resumed from snapshot step 20") for ln in resumed):
        raise SystemExit("[resilience-cli] the resumed chaos run differs "
                         "from the uninterrupted one")
    print(f"[resilience-cli] twin_loop --chaos (poisson, 30 jobs, 16 nodes): "
          f"killed after cycle 20 and resumed, the metric table, what-if "
          f"breakdown and policy mix equal the uninterrupted run's; "
          f"--train 2 --train-pop 4 --train-dir and --pool trained:<dir>,"
          f"paper: cuda and cpu print the same reports (every step); K1 "
          f"launches on cuda {launches}")
    for line in runs["cuda", "train"][0]:
        if line.startswith(("gen ", "    trained[")):
            print(f"[resilience-cli]   {line.strip()}")
    return launches


def learning_phase(torch, pe, engine):
    """Phase 14: learning, checkpoints, snapshots and chaos on the card,
    K1 the pass of every path."""
    t_phase = time.perf_counter()
    card = card_line()
    sin_on_card(torch)
    tr = training_phase(torch, pe, card)
    snap = snapshot_phase(torch, pe, engine, card)
    cli = cli_phase(torch, pe)
    print(f"[learning] phase 14: {time.perf_counter() - t_phase:.1f} s")
    return dict(training_pass=tr["k1"], launches_by_path={
        "polaris_training": tr["launches"],
        "training_gen0_scenario0": tr["one_launches"],
        "training_resume": tr["resume_launches"],
        "trained_deploy": tr["deploy_launches"],
        "snapshot_restore_cycles": snap["launches"],
        **{f"cli_{k}": v for k, v in cli.items()}})


# --------------------------------------------------------------- phase 15
FLEET_SCENARIOS = 256        # (a): 256 days of phase 12's trace family
FLEET_BLOCK = 64             # scenarios a block: 4 blocks of 2,048 forks
FLEET_DEPTH = 2              # prefetch depth (and 0, the ablation)
FLEET_SUB = (16, 8)          # (b): the first 16 scenarios, blocks of 8;
#                              (a) holds them against the reference backend
FLEET_PASS = 500             # (a): K1 checked on this launch (0-based) of
#                              the one-shot grid and of the stream's block 0
FLEET_FAN_BLOCK = 4          # (c): pseudo-scenarios a block of the fan
FLEET_RACE_BLOCK = 8         # (c): window rows a block of the race
FLEET_FLAGS = ["--shard", "0", "--block-size", "4", "--prefetch", "2"]
FLEET_CLI = ([], ["--fan", "8"], ["--fan", "8", "--race"])
EXAMPLES = ("quickstart", "fleet_twin", "train_policy")
LEGACY_RTOL = 1e-5           # (d): the legacy decide's costs against decide


def fleet_scenarios():
    """(a)'s grid: ``poisson_trace(500, 560, 100.0, (1, 11), (300.0,
    86400.0), seed=s, heavy_tail=True)`` for s in 0..255 (phase 12's
    eight are the first), J=1024."""
    from repro_torch.cluster.workload import poisson_trace, stack_scenarios
    return stack_scenarios(
        [poisson_trace(REPLAY_JOBS, POLARIS_NODES, REPLAY_GAP, (1, 11),
                       (300.0, 86400.0), seed=s, heavy_tail=True)
         for s in range(FLEET_SCENARIOS)],
        POLARIS_NODES, max_jobs=POLARIS_SLOTS)


class HostReads:
    """Counts the replay loop's host reads (calls of ``des.replay_cond``,
    one a ``des.REPLAY_BLOCK`` steps of each replay) while it is open."""

    def __enter__(self):
        from repro_torch.core import des
        self.des, self.real, self.n = des, des.replay_cond, 0

        def counted(c, arrival_t):
            self.n += 1
            return self.real(c, arrival_t)
        des.replay_cond = counted
        return self

    def __exit__(self, *exc):
        self.des.replay_cond = self.real


def differing(torch, a, b, fields, metrics=True):
    """The fields (and metric fields) in which two outcomes differ."""
    bad = [f for f in fields if not torch.equal(getattr(a, f),
                                                getattr(b, f))]
    if metrics:
        bad += [f"metrics.{f}" for f, x in a.metrics._asdict().items()
                if not torch.equal(x, getattr(b.metrics, f))]
    return bad


GRID_FIELDS = ("start_t", "end_t", "deadlocked", "events", "costs", "best")


def fleet_grid_run(torch, pe, fn):
    """``fn()`` from K1's count and the peak memory reset: (outcome, wall,
    K1 launches, host reads, peak bytes, bytes already allocated at the
    reset — earlier outcomes this phase still holds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    pe.LAUNCHES = 0
    with HostReads() as reads:
        t0 = time.perf_counter()
        out = fn()
        out.best.cpu()
        wall = time.perf_counter() - t0
    if pe.LAUNCHES == 0:
        raise SystemExit("[fleet] a fleet path never launched K1")
    return (out, wall, pe.LAUNCHES, reads.n,
            torch.cuda.max_memory_allocated(), live)


def fleet_stream_phase(torch, pe, card):
    """(a) the one-shot grid of 256 Polaris days against the stream in
    blocks of 64 at prefetch depths 2 and 0; (b) two shards of cuda:0
    over the first 16 scenarios against the one-shot rows."""
    from repro_torch.cluster.workload import slice_scenarios
    from repro_torch.core.des import state_metrics
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.state import map_state
    from repro_torch.core.whatif import sharded_replay_grid
    from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
    t0 = time.perf_counter()
    scen = fleet_scenarios()
    make_s = time.perf_counter() - t0
    pool = parse_pool(DRAS_POOL)
    S, P, J = FLEET_SCENARIOS, len(pool), POLARIS_SLOTS
    cuda = DrainEngine("cuda", device="cuda")
    print(f"[fleet] {S} scenarios of {REPLAY_JOBS} jobs on {POLARIS_NODES} "
          f"nodes (J={J}) x the k={P} DRAS pool = {S * P} forks "
          f"({S * P * J:,} job slots), goal score; the traces took "
          f"{make_s:.1f} s to make on the host")
    (one, one_s, one_k1, one_reads, one_mem, one_live), one_pass = (
        capture_pass(pe, lambda: fleet_grid_run(
            torch, pe, lambda: cuda.replay_grid(scen, pool.spec, "score")),
            at=FLEET_PASS, host=True))
    runs = {}
    for depth in (FLEET_DEPTH, 0):
        run = sharded_replay_grid(make_fleet_mesh(), engine=cuda,
                                  objective="score", block_size=FLEET_BLOCK,
                                  prefetch_depth=depth)
        runs[depth], block_pass = capture_pass(
            pe, lambda: fleet_grid_run(torch, pe,
                                       lambda: run(scen, pool.spec)),
            at=FLEET_PASS, host=True)
        bad = differing(torch, runs[depth][0], one, GRID_FIELDS)
        if bad:
            raise SystemExit(f"[fleet] the stream (blocks of {FLEET_BLOCK},"
                             f" prefetch {depth}) differs from the "
                             f"one-shot grid in {bad}")
    if one.deadlocked.any() or not torch.isfinite(one.costs).all():
        raise SystemExit("[fleet] a fork deadlocked or has no finite cost")
    n_blk = S // FLEET_BLOCK
    mib = lambda r: (f"peak {r[4] / 2**20:.1f} MiB ({(r[4] - r[5]) / 2**20:.1f}"
                     f" above the {r[5] / 2**20:.1f} MiB live at its start)")
    print(f"[fleet] streamed == one-shot on the card at prefetch "
          f"{FLEET_DEPTH} and 0: start_t, end_t, deadlocked, events, every "
          f"metric, costs and winners identical (tolerance: none)")
    one_run = (one, one_s, one_k1, one_reads, one_mem, one_live)
    print(f"[fleet] {card}: one-shot wall {one_s:.3f} s, {mib(one_run)}, "
          f"{int(one.result.iters)} iterations, {one_k1} K1 launches, "
          f"{one_reads} host reads; streamed ({n_blk} blocks of "
          f"{FLEET_BLOCK * P} forks) prefetch {FLEET_DEPTH}: wall "
          f"{runs[FLEET_DEPTH][1]:.3f} s, {mib(runs[FLEET_DEPTH])}, "
          f"{int(runs[FLEET_DEPTH][0].result.iters)} iterations summed, "
          f"{runs[FLEET_DEPTH][2]} K1 launches, {runs[FLEET_DEPTH][3]} host "
          f"reads; prefetch 0: wall {runs[0][1]:.3f} s, {mib(runs[0])}, "
          f"{runs[0][2]} K1 launches, {runs[0][3]} host reads + {n_blk} "
          f"block syncs (each run copied launch {FLEET_PASS + 1}'s inputs "
          f"to the host once, for the checks below)")
    which = f"pass {FLEET_PASS + 1}"
    k1 = dict(one_shot=k1_on(torch, pe, one_pass, "[fleet] one-shot:", which),
              block=k1_on(torch, pe, block_pass, "[fleet] block 0:", which))
    del one_pass, block_pass

    # the stream's rows of the first 16 scenarios against the reference
    # backend (the plain pass) on the card
    n_sub, b_sub = FLEET_SUB
    sub = slice_scenarios(scen, 0, n_sub)
    stream = runs[FLEET_DEPTH][0]
    before = pe.LAUNCHES
    t0 = time.perf_counter()
    ref = DrainEngine("reference", device="cuda").replay_grid(
        sub, pool.spec, "score")
    ref.best.cpu()
    ref_s = time.perf_counter() - t0
    if pe.LAUNCHES != before:
        raise SystemExit("[fleet] the reference backend launched K1")
    bad = [f for f in GRID_FIELDS if not torch.equal(
        getattr(ref, f), getattr(stream, f)[:n_sub])]
    bad += [f"metrics.{f}" for f, x in ref.metrics._asdict().items()
            if not torch.equal(x, getattr(stream.metrics, f)[:n_sub])]
    if bad:
        raise SystemExit(f"[fleet] the reference backend on the first "
                         f"{n_sub} scenarios differs from the stream's rows "
                         f"in {bad}")
    print(f"[fleet] the reference backend (plain pass) on the first {n_sub} "
          f"scenarios ({n_sub * P} forks) == the stream's rows of block 0: "
          f"times, deadlocks, events, every metric, costs and winners "
          f"identical (tolerance: none); {ref_s:.3f} s on {card}")

    # (b) two shards of cuda:0 over the first 16 scenarios, blocks of 8
    two, two_s, two_k1, two_reads, _, _ = fleet_grid_run(
        torch, pe, lambda: sharded_replay_grid(
            FleetMesh(["cuda:0", "cuda:0"]), engine=cuda, objective="score",
            block_size=b_sub)(sub, pool.spec))
    rows = n_sub * P
    rep = lambda x, dt: torch.as_tensor(x, dtype=dt).cuda(  # noqa: E731
        ).repeat_interleave(P, 0)
    alone = state_metrics(map_state(lambda x: x[:rows], one.result.state),
                          rep(sub.valid, torch.bool),
                          rep(sub.true_runtime, torch.float32))
    parted = [f for f, x in alone._asdict().items()
              if not torch.equal(x.reshape(n_sub, P),
                                 getattr(one.metrics, f)[:n_sub])]
    print(f"[fleet] the one-shot rows of the first {n_sub} scenarios "
          f"({rows} of {S * P} forks) scored alone: metrics "
          + ("identical to the full grid's" if not parted else
             f"differ from the full grid's in {parted}")
          + " (torch's row reduction at another row count)")
    for f in ("start_t", "end_t", "deadlocked", "events", "costs", "best"):
        if not torch.equal(getattr(two, f), getattr(one, f)[:n_sub]):
            raise SystemExit(f"[fleet] two shards of cuda:0 differ from "
                             f"the one-shot rows in {f}")
    bad = [f for f, x in two.metrics._asdict().items()
           if not torch.equal(x, getattr(one.metrics, f)[:n_sub])]
    if bad:
        raise SystemExit(f"[fleet] two shards of cuda:0 differ from the "
                         f"one-shot rows in metrics {bad}")
    print(f"[fleet] (b) a mesh of cuda:0 named twice (2 shards), the first "
          f"{n_sub} scenarios in blocks of {b_sub}: == the one-shot grid's "
          f"rows (times, deadlocks, events, metrics, costs, winners); "
          f"{two_s:.3f} s, {two_k1} K1 launches, {two_reads} host reads "
          f"on {card}")
    return dict(one=one_k1, stream=runs[FLEET_DEPTH][2],
                stream0=runs[0][2], two=two_k1, k1=k1)


def fleet_fan_phase(torch, pe, card, fan_grid, race_grid):
    """(c) ``sharded_fan_grid`` over phase 13 (e)'s fan, blocks of 4
    pseudo-scenarios, against that phase's ``fan_grid``;
    ``sharded_race_grid`` F0=4 -> 16, blocks of 8 window rows, against
    phase 13 (f)'s ``race_grid`` (each given as (outcome, wall))."""
    from repro_torch.cluster.workload import stack_scenarios
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.race import RaceSpec
    from repro_torch.core.whatif import sharded_fan_grid, sharded_race_grid
    from repro_torch.launch.mesh import make_fleet_mesh
    traces, _ = polaris_traces()
    scen = stack_scenarios(traces[:FAN_GRID_SCENARIOS], POLARIS_NODES,
                           max_jobs=POLARIS_SLOTS)
    pool = parse_pool(DRAS_POOL)
    spec = FanSpec(**FAN_GRID)
    cuda = DrainEngine("cuda", device="cuda")
    launches = {}

    def counted(name, fn):
        pe.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pe.LAUNCHES == 0:
            raise SystemExit(f"[fleet-fan] {name} never launched K1")
        launches[name] = pe.LAUNCHES
        return out, wall
    (want, fan_s), (race_want, race_s) = fan_grid, race_grid
    got, stream_s = counted("fleet_fan", lambda: sharded_fan_grid(
        make_fleet_mesh(), engine=cuda, objective=FAN_GRID_GOAL, fan=spec,
        block_size=FLEET_FAN_BLOCK)(scen, pool.spec))
    bad = differing(torch, got, want, ("start_t", "end_t", "deadlocked",
                                       "events", "member_costs", "costs",
                                       "best", "cost_ci", "fan_width"))
    if bad:
        raise SystemExit(f"[fleet-fan] sharded_fan_grid differs from "
                         f"fan_grid in {bad}")
    F, P = spec.n, len(pool)
    print(f"[fleet-fan] sharded_fan_grid (S=1 x F={F} x k={P}, blocks of "
          f"{FLEET_FAN_BLOCK} pseudo-scenarios = {FLEET_FAN_BLOCK * P} "
          f"forks) == phase 13 (e)'s fan_grid: times, deadlocks, events, "
          f"metrics, member costs, costs, winners, CI and width identical; "
          f"{card}: streamed {stream_s:.3f} s ({launches['fleet_fan']} K1 "
          f"launches), one-shot {fan_s:.3f} s")
    race = RaceSpec(fan=spec, f0=RACE_F0)
    got, srace_s = counted("fleet_race", lambda: sharded_race_grid(
        make_fleet_mesh(), engine=cuda, objective=FAN_GRID_GOAL, race=race,
        block_size=FLEET_RACE_BLOCK)(scen, pool.spec))
    same = (list(got.best) == list(race_want.best)
            and [r.members for r in got.rungs] == [r.members
                                                   for r in race_want.rungs]
            and got.members == race_want.members
            and list(got.keep) == list(race_want.keep))
    if not same:
        raise SystemExit(f"[fleet-fan] sharded_race_grid (winners "
                         f"{list(got.best)}, {got.members} members) differs "
                         f"from race_grid ({list(race_want.best)}, "
                         f"{race_want.members})")
    print(f"[fleet-fan] sharded_race_grid F0={race.f0} -> F_max="
          f"{race.f_max}, blocks of {FLEET_RACE_BLOCK} window rows: winners"
          f", rungs and members == phase 13 (f)'s race_grid ({got.members} "
          f"of {got.members_full}; "
          + ", ".join(f"[{r.lo},{r.hi}) x {len(r.active)}" for r in got.rungs)
          + f"); {card}: streamed {srace_s:.3f} s "
          f"({launches['fleet_race']} K1 launches), race_grid {race_s:.3f} s")
    return launches


def fleet_whatif_phase(torch, pe, snapshot, card):
    """(d) ``sharded_whatif`` on phase 4's mirror, one shard and cuda:0
    named twice, against ``decide``; ``decide_legacy_vmap`` there."""
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.policies import parse_pool
    from repro_torch.core.whatif import decide_legacy_vmap, sharded_whatif
    from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
    pool = parse_pool(DRAS_POOL)
    cuda = DrainEngine("cuda", device="cuda")
    want = cuda.decide(snapshot, pool.spec, "score")
    launches, walls = 0, []
    for mesh in (make_fleet_mesh(), FleetMesh(["cuda:0", "cuda:0"])):
        pe.LAUNCHES = 0
        t0 = time.perf_counter()
        got = sharded_whatif(mesh, engine=cuda, objective="score")(
            snapshot, pool)
        got.costs.cpu()
        walls.append(time.perf_counter() - t0)
        if pe.LAUNCHES == 0:
            raise SystemExit("[fleet-whatif] sharded_whatif never launched "
                             "K1")
        launches += pe.LAUNCHES
        for f in ("policy_index", "costs", "run_mask", "deadlocked"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise SystemExit(f"[fleet-whatif] {mesh.shape['data']} "
                                 f"shard(s): {f} differs from decide")
    pe.LAUNCHES = 0
    t0 = time.perf_counter()
    legacy = decide_legacy_vmap(snapshot, pool)
    legacy.costs.cpu()
    legacy_s = time.perf_counter() - t0
    legacy_launches = pe.LAUNCHES
    if legacy_launches == 0:
        raise SystemExit("[fleet-whatif] decide_legacy_vmap never launched "
                         "K1")
    if not (int(legacy.policy_index) == int(want.policy_index)
            and torch.equal(legacy.run_mask, want.run_mask)
            and torch.equal(legacy.deadlocked, want.deadlocked)):
        raise SystemExit(f"[fleet-whatif] decide_legacy_vmap picks "
                         f"{int(legacy.policy_index)}, decide "
                         f"{int(want.policy_index)}, or their qrun sets or "
                         f"deadlocks differ")
    # one scalar drain a policy scores one row at a time; decide scores
    # the k rows together, so torch may sum a row in another order
    if not torch.allclose(legacy.costs, want.costs, rtol=LEGACY_RTOL,
                          atol=0.0):
        raise SystemExit(f"[fleet-whatif] decide_legacy_vmap's costs differ "
                         f"from decide's beyond rtol {LEGACY_RTOL}")
    fin = torch.isfinite(want.costs)
    rel = float(((legacy.costs - want.costs).abs()[fin]
                 / want.costs.abs()[fin]).max()) if fin.any() else 0.0
    print(f"[fleet-whatif] sharded_whatif on phase 4's mirror (k={len(pool)}"
          f"), 1 shard and cuda:0 named twice: policy_index, costs, "
          f"run_mask, deadlocked == decide (tolerance: none); "
          f"{walls[0]:.3f} / {walls[1]:.3f} s, {launches} K1 launches; "
          f"decide_legacy_vmap (the scalar drain once per policy, K1 its "
          f"pass, {legacy_launches} launches): the same winner "
          f"({pool.names[int(want.policy_index)]}), qrun set "
          f"({int(want.run_mask.sum())} jobs) and deadlocks "
          f"({int(want.deadlocked.sum())}); costs within rtol {LEGACY_RTOL} "
          f"(largest relative difference {rel:.3g}, "
          f"{int((legacy.costs != want.costs).sum())} of {len(pool)} not "
          f"bitwise); {legacy_s:.1f} s on {card}")
    return launches, legacy_launches


def fleet_cli(device, flags):
    """``twin_loop --replay-grid 8`` with ``flags`` at the CLI's grid size:
    the table and winners, the first line cut before its mode."""
    import contextlib
    import io
    from repro_torch.launch import twin_loop
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        twin_loop.main(["--replay-grid", "8", "--trace", "poisson",
                        "--jobs", "48", "--nodes", "32", "--pool",
                        "extended", "--device", device] + flags)
    lines = buf.getvalue().splitlines()
    i = next(n for n, line in enumerate(lines)
             if line.startswith(("replay grid:", "raced grid:")))
    return [lines[i].split(" (", 1)[0]] + lines[i + 1:], lines[i]


def fleet_cli_phase(torch, pe):
    """(e) each grid mode with the fleet flags on cuda and cpu against the
    mode without them."""
    launches = 0
    for mode in FLEET_CLI:
        pe.LAUNCHES = 0
        on_cuda, line = fleet_cli("cuda", mode + FLEET_FLAGS)
        if pe.LAUNCHES == 0:
            raise SystemExit(f"[fleet-cli] {mode} never launched K1")
        launches += pe.LAUNCHES
        on_cpu, _ = fleet_cli("cpu", mode + FLEET_FLAGS)
        plain, _ = fleet_cli("cpu", mode)
        if not on_cuda == on_cpu == plain:
            raise SystemExit(f"[fleet-cli] --replay-grid 8 {' '.join(mode)}"
                             f": the fleet reports differ from each other "
                             f"or from the one-shot's")
        print(f"[fleet-cli] {line}")
    print(f"[fleet-cli] twin_loop --replay-grid 8 [--fan 8 [--race]] "
          f"{' '.join(FLEET_FLAGS)} (poisson, 48 jobs, 32 nodes, extended "
          f"pool): cuda and cpu print the one-shot grid's table and winners;"
          f" K1 launches {launches}")
    return launches


EXAMPLE_RUN = ("import time\n"
               "from repro_torch.examples import {name} as example\n"
               "from repro_torch.kernels import policy_eval as pe\n"
               "t0 = time.perf_counter()\n"
               "example.main(['--device', 'cuda'])\n"
               "print('EXAMPLE', pe.LAUNCHES, time.perf_counter() - t0)\n")


def examples_phase(card):
    """(f) the three examples on cuda, each ``main`` in a process of its
    own, all three at once: each must exit 0; its wall and K1 launches
    (counted in its process from 0) are printed, and the wall of the
    three together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUN.format(name=name)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    launches = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"[examples] {name} exited "
                                 f"{proc.returncode}: {err[-3000:]}")
            tag, n, wall = out.strip().splitlines()[-1].split()
            if tag != "EXAMPLE" or int(n) == 0:
                raise SystemExit(f"[examples] {name} never launched K1")
            launches[f"example_{name}"] = int(n)
            last = out.strip().splitlines()[-2]
            print(f"[examples] python -m repro_torch.examples.{name}: exit "
                  f"0 after {float(wall):.1f} s on {card}, {n} K1 launches; "
                  f"last line: {last[:100]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[examples] the three ran side by side in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def fleet_phase(torch, pe, snapshot, mc):
    """Phase 15: fleet-scale block streaming, shards on one card, the
    legacy oracle, the fleet CLI and the examples, K1 the pass of every
    path (``mc``: phase 13's result, whose fan and race grids are the
    one-shot side of (c)).  Returns (K1 on the fleet grids' passes, K1's
    launches by path)."""
    t_phase = time.perf_counter()
    card = card_line()
    grid = fleet_stream_phase(torch, pe, card)
    fan = fleet_fan_phase(torch, pe, card, mc["fan_grid"], mc["race_grid"])
    whatif, legacy = fleet_whatif_phase(torch, pe, snapshot, card)
    cli = fleet_cli_phase(torch, pe)
    examples = examples_phase(card)
    print(f"[fleet] phase 15: {time.perf_counter() - t_phase:.1f} s")
    return grid["k1"], {
        "fleet_one_shot": grid["one"], "fleet_stream": grid["stream"],
        "fleet_stream_prefetch0": grid["stream0"],
        "fleet_two_shards": grid["two"], **fan,
        "fleet_whatif": whatif, "fleet_legacy_decide": legacy,
        "fleet_cli": cli, **examples}


# ------------------------------------------------- on request: --parent
def read(path):
    with open(path) as f:
        return f.read()


def build_other(name, text, tag):
    """Build a kernel's CUDA source ``text`` (another tree's, or an
    instrumented copy) with the port's nvcc flags into ``build/<tag>/``
    and load it; the port's own libraries are untouched."""
    import ctypes
    from repro_torch.kernels import build
    out_dir = os.path.join(ROOT, "build", tag)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"{name}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True, timeout=600)
    return ctypes.CDLL(so)


def k3_raw_launch(torch, fn, r, k, v, w, u):
    """K3's C entry (``fn``) on fixed output buffers."""
    b, s, h, n = r.shape
    y = torch.empty_like(r)
    st = torch.empty((b, h, n, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, y, st)]

    def launch():
        if fn(*ptrs, b, s, h, n, stream) != 0:
            raise SystemExit("[k3] launch failed")
    return launch, y, st


def k2_parent(torch, csrc):
    """K2's rglru_fwd of the checkout at ``csrc``'s tree against this
    tree's at B=1, S=2048, W=2560 (f32), in turns; their outputs must be
    equal (both are bitwise to rglru_scan)."""
    import ctypes
    from repro_torch.kernels import rglru as rg
    text = read(os.path.join(csrc, "rglru.cu"))
    old = build_other("rglru", text, "parent").rglru_fwd
    # the entry took (a, x, h0, h_all, h_final, B, S, W, stream) before
    # its path argument
    n_int = 4 if "int tma" in text else 3
    old.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (1, 2048, 2560)
    a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
    x = torch.randn(shape, generator=gen, device="cuda")
    h0 = torch.randn((1, 2560), generator=gen, device="cuda")
    outs = [(torch.empty_like(a), torch.empty_like(h0)) for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    new = rg._kernel("rglru_fwd")

    def launch(fn, out, extra):
        args = [t.data_ptr() for t in (a, x, h0, *out)] + [1, 2048, 2560]
        if fn(*args, *extra, stream) != 0:
            raise SystemExit("[parent] K2 launch failed")
    fns = [lambda: launch(old, outs[0], [1] * (n_int - 3)),
           lambda: launch(new, outs[1], [1])]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(*outs)):
        raise SystemExit("[parent] K2 of the parent and of this tree differ")
    turns = [time_median_ms(torch, fns[i], 20) for i in (0, 1, 1, 0)]
    print(f"[parent] K2 rglru (B=1, S=2048, W=2560, f32): parent "
          f"{turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us, this tree "
          f"{turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us per launch "
          f"(turns parent, change, change, parent); outputs equal")


def compare_parent(torch, parent, drain_inputs):
    """K1 (first drain pass, and the mean over the captured drain), K2's
    rglru and K3 (rwkv6-7b, S=1000) of the checkout at ``parent`` against
    this tree's, built from each tree's source, on the same inputs, timed
    in turns: parent, change, change, parent.  Also checks that both give
    the same K1 and K2 answers and K3 within 2e-4 of each other."""
    import ctypes
    from repro_torch.kernels import policy_eval as pe
    from repro_torch.kernels import wkv6 as wk
    csrc = os.path.join(parent, "src", "repro_torch", "csrc")
    old_pe = build_other("policy_eval",
                         read(os.path.join(csrc, "policy_eval.cu")),
                         "parent").policy_eval_pass_batched
    old_pe.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    old_wk = build_other("wkv6", read(os.path.join(csrc, "wkv6.cu")),
                         "parent").wkv6_fwd
    old_wk.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    first = drain_inputs[0]
    k, J = first[0].shape
    outs = [(torch.empty((k, J), dtype=torch.bool, device="cuda"),
             torch.empty((k,), dtype=torch.int32, device="cuda"))
            for _ in range(2)]
    pair = [raw_launch(torch, pe, first, fn=old_pe, out=outs[0]),
            raw_launch(torch, pe, first, out=outs[1])]
    for launch in pair:
        launch()
    torch.cuda.synchronize()
    if not (torch.equal(*[o[0] for o in outs])
            and torch.equal(*[o[1] for o in outs])):
        raise SystemExit("[parent] K1 of the parent and of this tree differ")
    drains = [drain_launches(torch, pe, drain_inputs, fn=old_pe),
              drain_launches(torch, pe, drain_inputs)]
    for what, fns, n, per in (("K1 first drain pass", pair, 500, 1),
                              (f"K1 mean over {len(drain_inputs)} drain "
                               f"passes", drains, 20, len(drain_inputs))):
        turns = [time_median_ms(torch, fns[i], n) / per for i in (0, 1, 1, 0)]
        print(f"[parent] {what} (k={k}, J={J}): parent "
              f"{turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, this tree "
              f"{turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us per launch "
              f"(turns parent, change, change, parent)")
    k2_parent(torch, csrc)
    r, k_, v, w, u = wkv_inputs(torch, 1000, seed=1000)
    old_l, y0, s0 = k3_raw_launch(torch, old_wk, r, k_, v, w, u)
    new_l, y1, s1 = k3_raw_launch(torch, wk._kernel(), r, k_, v, w, u)
    old_l()
    new_l()
    torch.cuda.synchronize()
    err = max(worst_excess(y1, y0, 2e-4)[0], worst_excess(s1, s0, 2e-4)[0])
    turns = [time_median_ms(torch, (old_l, new_l)[i], 10)
             for i in (0, 1, 1, 0)]
    print(f"[parent] K3 (B=1, H=64, N=64, S=1000, f32): parent "
          f"{turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us, this tree "
          f"{turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us per launch "
          f"(turns parent, change, change, parent); max abs difference "
          f"{err:.3g}")


# --------------------------------------------- on request: --k1-phases
def instrument_k1(text):
    """A copy of a K1 source with clock64() stamps: at the kernel's entry,
    behind a block barrier before each ``// ---- `` phase comment in
    ``pass_kernel``, before its write-out loop and at its end, into a
    device array read by an added C entry.  The barriers are added ones;
    each phase is named by its comment."""
    import re
    start = text.index("pass_kernel(")
    body = text.index("{", text.index(") {", start))
    depth, end = 0, body
    for end in range(body, len(text)):
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        if depth == 0:
            break
    lines = text[body + 1:end].split("\n")
    names, out = ["entry"], []
    stamp = ("__syncthreads(); if (threadIdx.x == 0) "
             "k1_stamps[blockIdx.x * 16 + {}] = clock64();")
    last_out = max(i for i, ln in enumerate(lines) if "started_out[" in ln)
    write_at = max(i for i in range(last_out) if re.match(
        r"^  (if|for) \(", lines[i]))
    for i, ln in enumerate(lines):
        m = re.search(r"// ---- (.*?)[:-]* *-*$", ln)
        if m or i == write_at:
            label = re.split(r"[:=]", m.group(1))[0] if m else "write-out"
            names.append("walk" if m and "walk" in m.group(1)
                         else " ".join(label.split()[:3]).strip(" +"))
            out.append(stamp.format(len(names) - 1))
        out.append(ln)
    names.append("end")
    out.append(stamp.format(len(names) - 1))
    head = ("\n  if (threadIdx.x == 0) k1_stamps[blockIdx.x * 16] = "
            "clock64();")
    text = (text[:start] + text[start:body + 1] + head + "\n".join(out)
            + text[end:])
    decl = "__device__ long long k1_stamps[64 * 16];\n"
    text = text.replace("namespace {", "namespace {\n" + decl, 1)
    return text, names


def k1_phases(torch, drain_inputs):
    """Each phase of K1 in clocks, from an instrumented copy of each
    source (this tree's, and the parent's with ``--parent``) built into
    ``build/``, on the captured drain passes: the first pass's slowest
    block, and the mean over the passes of each pass's slowest block."""
    import ctypes
    import numpy as np
    from repro_torch.kernels import policy_eval as pe
    sources = {"this tree": os.path.join(ROOT, "src", "repro_torch", "csrc",
                                         "policy_eval.cu")}
    if "--parent" in sys.argv:
        sources["parent"] = os.path.join(
            sys.argv[sys.argv.index("--parent") + 1], "src", "repro_torch",
            "csrc", "policy_eval.cu")
    reader = ('\nextern "C" int k1_read_stamps(void* dst, int clear) {\n'
              '  cudaError_t e = cudaMemcpyFromSymbol(dst, k1_stamps, '
              'sizeof(k1_stamps));\n'
              '  if (clear) { static long long z[64 * 16]; '
              'e = cudaMemcpyToSymbol(k1_stamps, z, sizeof(z)); }\n'
              '  return (int)e;\n}\n')
    for tag, src in sources.items():
        text, names = instrument_k1(read(src))
        lib = build_other(tag.split()[0], text + reader, "k1_phases")
        fn = lib.policy_eval_pass_batched
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.k1_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        host = np.zeros(64 * 16, np.int64)
        per = []
        for a in drain_inputs:
            launch = raw_launch(torch, pe, a, fn=fn)
            for _ in range(3):                 # warm; keep the last
                lib.k1_read_stamps(host.ctypes.data, 1)
                launch()
                torch.cuda.synchronize()
            lib.k1_read_stamps(host.ctypes.data, 1)
            st = host.reshape(64, 16)[:a[0].shape[0], :len(names)].copy()
            for c in range(1, len(names)):     # a phase not reached
                st[:, c] = np.where(st[:, c] == 0, st[:, c - 1], st[:, c])
            per.append(np.diff(st, axis=1).max(0))
        per = np.array(per)
        cells = ", ".join(f"{nm} {per[0][i]} / {per[:, i].mean():.0f}"
                          for i, nm in enumerate(names[:-1]))
        print(f"[k1 phases] {tag}: clocks of the slowest block, first pass "
              f"/ mean over {len(per)} drain passes: {cells}; sum "
              f"{per[0].sum()} / {per.sum(1).mean():.0f}")


# --------------------------------------------- on request: --k2-phases
def k2_phases(torch):
    """The chain warp's clocks a step, waiting for a full tile and
    working, mean over the blocks, from instrumented copies of K2's
    source: as it is, with the workers only passing the tile barriers,
    and without the output's TMA store (the outputs of the last two are
    not K2's; only their clocks are read)."""
    import ctypes
    import numpy as np
    text = read(os.path.join(ROOT, "src", "repro_torch", "csrc",
                             "rglru.cu"))
    text = text.replace("namespace {", "namespace {\n__device__ long long "
                        "k2_clk[1 << 13];", 1)
    stamps = [
        ("      bar_sync(kBarFull + (c & 1), kThreads);\n",
         "      long long t0 = clock64();\n"
         "      bar_sync(kBarFull + (c & 1), kThreads);\n"
         "      long long t1 = clock64();\n      wait_clk += t1 - t0;\n"),
        ("      __syncwarp();\n      bar_arrive(kBarEmpty",
         "      __syncwarp();\n      work_clk += clock64() - t1;\n"
         "      bar_arrive(kBarEmpty"),
        ("    float h = 0.0f;\n",
         "    float h = 0.0f;\n    long long wait_clk = 0, work_clk = 0;\n"),
        ("    if (live) p.h_final[hc] = h;\n",
         "    if (live) p.h_final[hc] = h;\n    if (lane == 0) {\n"
         "      const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
         "      k2_clk[2 * blk] = wait_clk;\n"
         "      k2_clk[2 * blk + 1] = work_clk;\n    }\n")]
    variants = {
        "as it is": [],
        "workers only pass the tile barriers": [
            ("  for (int c = 0; c < kStages - 2; ++c) w.issue(c);\n", ""),
            ("    w.wait(c);\n    bar_sync(kBarWork, kWorkers);\n"
             "    w.issue(c + kStages - 2);\n    w.stage(c);\n", ""),
            ("      w.output(c - 1);\n", ""),
            ("  w.output(n_chunks - 1);\n", "")],
        "no TMA store of the output": [
            ("      if (wt == 0) tma_store(maps + S::kIn, smem_addr(o), col0, "
             "c * kSteps, b);\n", "")]}
    reader = ('\nextern "C" int k2_read(void* dst) {\n  return (int)'
              'cudaMemcpyFromSymbol(dst, k2_clk, sizeof(k2_clk));\n}\n')
    gen = torch.Generator(device="cuda").manual_seed(4)
    s, w = 2048, 2560
    a = torch.sigmoid(torch.randn((1, s, w), generator=gen, device="cuda"))
    x = torch.randn((1, s, w), generator=gen, device="cuda")
    h0 = torch.zeros((1, w), device="cuda")
    gated = k2_gated_inputs(torch, 1, s, w, torch.bfloat16, seed=4)
    host = np.zeros(1 << 13, np.int64)
    n_blocks, n_steps = w // 8, s
    for name, edits in variants.items():
        src = text
        for old, new in stamps + edits:
            if old not in src:
                raise SystemExit(f"[k2 phases] {name}: no {old.strip()!r}")
            src = src.replace(old, new)
        lib = build_other("rglru", src + reader,
                          "k2_phases_" + str(len(edits)))
        lib.k2_read.argtypes = [ctypes.c_void_p]
        fwd, gfn = lib.rglru_fwd, lib.rglru_gated_fwd
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        gfn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream
        out = [torch.empty_like(a), torch.empty_like(h0),
               torch.empty_like(gated[0])]
        calls = {
            "rglru": lambda: fwd(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                                 out[0].data_ptr(), out[1].data_ptr(), 1, s,
                                 w, 1, stream),
            "gated": lambda: gfn(*[t.data_ptr() for t in gated], None,
                                 out[2].data_ptr(), out[1].data_ptr(), 1, s,
                                 w, 1, 1, stream)}
        cells = []
        for entry, call in calls.items():
            ms = time_median_ms(torch, call, 10)
            call()
            torch.cuda.synchronize()
            lib.k2_read(host.ctypes.data)
            clk = host[:2 * n_blocks].reshape(n_blocks, 2).mean(0) / n_steps
            cells.append(f"{entry} {ms * 1e3:.1f} us, chain waits "
                         f"{clk[0]:.1f} and works {clk[1]:.1f} clocks a step")
        print(f"[k2 phases] {name}: " + "; ".join(cells))


# --------------------------------------------------------------- phase 16
FAMILY_SERVE = dict(n_req=4, slots=2, lo=128, hi=1024, max_new=8)
FAMILY_MAX_SEQ = 1280
DEEPSEEK_LAYERS = 14         # (b): deepseek-v2-lite-16b cut from 27 layers
VLM_LAYERS = 8               # (c): internvl2-76b cut from 80 layers
VLM_PROMPTS = (2, 128, 768)  # (c): prompts, shortest and longest
VLM_STEPS = 8                # (c): decode steps a prompt
WHISPER_SERVE = dict(n_req=4, slots=2, max_seq=512, lo=64, hi=448,
                     max_new=8)
WHISPER_AUDIO = ((1500, 1500), (448, 1500))   # (e): (Sq, Sk), non-causal
AUDIO_Q_SCALE = 3.0          # (e): q's scale; scores of std 3
MLA_S = 512                  # (b): positions before the decoded one
#: A router flip is a near tie when the plain run's k-th and (k+1)-th
#: probabilities at the flipped token differ by less than this share of
#: the k-th (two bf16 steps of its logits are ~0.8%).
NEAR_TIE = 1e-2


def router_flip(torch, cfg, model, batch, want, what):
    """``what`` (a first-token logit difference past LOGIT_TOL against
    the plain run's ``want``) is accepted only for a MoE model whose
    routers part, first at a near tie, and whose kernels' prefill, rerun
    with every router's choice forced to the plain run's experts, comes
    back within LOGIT_TOL.  Prints the first token whose top-k set
    differs, with the plain run's k-th and (k+1)-th probabilities there,
    and the forced rerun's difference."""
    if cfg.family != "moe":
        raise SystemExit(what)
    from repro_torch.models import api
    from repro_torch.models import blocks_moe as bm
    route = bm.route

    def prefill(backend, fn):
        bm.route = fn
        try:
            with torch.inference_mode():
                return api.prefill(cfg, model, batch, backend)[0]
        finally:
            bm.route = route

    runs = {}
    for backend in ("cuda", "reference"):
        calls = []

        def traced_route(cfg_, params, xc, calls=calls):
            out = route(cfg_, params, xc)
            calls.append((out[1], out[3]))
            return out
        prefill(backend, traced_route)
        runs[backend] = calls
    k = cfg.moe.top_k
    parted = [(layer, t) for layer, ((_, idx), (_, ref_idx)) in enumerate(
        zip(runs["cuda"], runs["reference"]))
        for t in (idx.sort(-1).values != ref_idx.sort(-1).values).any(
            -1).nonzero()[:1, 0].tolist()]
    if not parted:
        raise SystemExit(f"{what}, and every router agrees")
    layer, t = parted[0]
    top = runs["reference"][layer][0][t].sort(descending=True).values
    pk, pk1 = float(top[k - 1]), float(top[k])
    near = pk - pk1 < NEAR_TIE * pk
    forced = iter([ref_idx for _, ref_idx in runs["reference"]])

    def forced_route(cfg_, params, xc):
        logits, probs, _, _ = route(cfg_, params, xc)
        idx = next(forced)
        gates = torch.gather(probs, 1, idx)
        return logits, probs, gates / torch.clamp(
            gates.sum(-1, keepdim=True), min=1e-9), idx
    diff = float((prefill("cuda", forced_route) - want).abs().max())
    print(f"{what}: the routers first part at MoE layer {layer}, token "
          f"{t}, where the plain run's probabilities ranked {k} and "
          f"{k + 1} are {pk:.6g} and {pk1:.6g} (gap {pk - pk1:.3g}, "
          f"{100 * (pk - pk1) / pk:.2f}% of the first: "
          f"{'a near tie' if near else 'NOT a near tie'}); with the plain "
          f"run's experts forced in every router, the kernels' logits "
          f"differ by {diff:.4g} (tolerance {LOGIT_TOL})")
    if not near or not diff <= LOGIT_TOL:
        raise SystemExit(f"{what}: not explained by a router near tie")


def moe_dispatch_check(torch, cfg, model):
    """(a) olmoe's two dispatches on the hidden states a 1024-token
    prefill hands layer 0's MoE: ``moe_dropped`` and the aux terms equal;
    GShard's y against gather's with every kept choice weighted by its
    token's kept gate sum (C17: the reference's GShard combine), within
    3e-2 of the largest |y| (bf16); the plain gather vs GShard difference
    (C17's size); each dispatch's time."""
    import dataclasses
    from repro_torch.models import api
    from repro_torch.models import blocks_moe as bm
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                         device="cuda")
    seen = []
    moe_apply = bm.moe_apply

    def capture(cfg_, params, x):
        if not seen:
            seen.append((params, x))
        return moe_apply(cfg_, params, x)
    bm.moe_apply = capture
    try:
        with torch.inference_mode():
            api.prefill(cfg, model, {"tokens": toks})
    finally:
        bm.moe_apply = moe_apply
    params, x = seen[0]
    m = cfg.moe
    capacity = max(int(m.top_k * 1024 * m.capacity_factor / m.n_experts), 4)
    cfgs = {d: dataclasses.replace(cfg, moe=dataclasses.replace(
        m, dispatch=d)) for d in ("gather", "gshard")}
    route = bm.route

    def summed(cfg_, params_, xc):
        logits, probs, gates, idx = route(cfg_, params_, xc)
        keep = bm.arrival_positions(idx, m.n_experts).reshape(
            idx.shape) < capacity
        return logits, probs, (gates * keep).sum(1, keepdim=True).expand(
            gates.shape), idx

    with torch.inference_mode():
        out = {d: bm.moe_apply(c, params, x) for d, c in cfgs.items()}
        bm.route = summed
        try:
            y_sum, _ = bm.moe_apply(cfgs["gather"], params, x)
        finally:
            bm.route = route
        ms = {d: time_median_ms(torch, lambda c=c: bm.moe_apply(c, params, x),
                                5, reps=3) for d, c in cfgs.items()}
    (y_g, aux_g), (y_s, aux_s) = out["gather"], out["gshard"]
    scale = float(y_s.float().abs().max())
    err = float((y_sum.float() - y_s.float()).abs().max()) / scale
    raw = float((y_g.float() - y_s.float()).abs().max()) / scale
    same_aux = all(torch.equal(aux_g[key], aux_s[key]) for key in aux_g)
    print(f"[serve {cfg.name}] dispatch on layer 0's 1024 tokens "
          f"(capacity {capacity}): moe_dropped "
          f"{float(aux_g['moe_dropped']):.0f} both, aux terms "
          f"{'identical' if same_aux else 'DIFFERENT'}; GShard vs gather "
          f"with C17's summed gates: max |diff| {100 * err:.3f}% of max |y| "
          f"(tolerance 3%); plain gather vs GShard {100 * raw:.1f}% (C17); "
          f"gather {ms['gather']:.2f} ms, GShard {ms['gshard']:.2f} ms")
    if not same_aux or not err <= 3e-2 or not torch.isfinite(y_s).all():
        raise SystemExit(f"[serve {cfg.name}] the dispatches disagree")


def mla_decode_check(torch, cfg, model):
    """(b) deepseek's first layer (dense_mla): MLA's absorbed decode of
    position S = ``MLA_S`` from the compressed caches of a prefill of S
    against the decompressed prefill of S + 1 at its last position,
    within 3e-2 of the largest |y| (bf16)."""
    from repro_torch.models import blocks_moe as bm
    from repro_torch.models.common import embed, rms_norm
    s = MLA_S
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen,
                         device="cuda")
    params = model.segs[0][0].params()
    pos = torch.arange(s + 1, dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        x = rms_norm(embed(toks, model.top.embed), params["attn_norm.scale"],
                     cfg.norm_eps)
        full, _ = bm.mla_apply(cfg, params, x, mode="prefill", cache=None,
                               positions=pos)
        _, cache = bm.mla_apply(cfg, params, x[:, :s], mode="prefill",
                                cache=None, positions=pos[:, :s])
        big = bm.init_mla_cache(cfg, 1, s + 1, torch.bfloat16, x.device)
        for name, t in cache.items():
            big[name][:, :s] = t
        step, _ = bm.mla_apply(cfg, params, x[:, s:], mode="decode",
                               cache=big, positions=pos[:, s:], index=s)
    want = full[:, s].float()
    err = float((step[:, 0].float() - want).abs().max() / want.abs().max())
    print(f"[serve {cfg.name}] MLA absorbed decode at S={s} vs the "
          f"decompressed prefill of {s + 1}: max |diff| {100 * err:.3f}% "
          f"of max |y| (tolerance 3%)")
    if not err <= 3e-2:
        raise SystemExit(f"[serve {cfg.name}] MLA decode parts from the "
                         f"prefill")


def vlm_phase(torch, fa):
    """(c) internvl2-76b at published widths cut to ``VLM_LAYERS`` layers
    (random bf16 weights, seed 0): 256 random patch embeddings and each
    of 2 prompts through ``api.prefill`` and ``VLM_STEPS`` greedy
    ``api.decode_step``s, with the kernels and with the plain versions;
    K4 ``VLM_LAYERS`` launches a prefill and none a step; first-token
    logits within LOGIT_TOL, streams equal or parting at a near tie.
    Returns K4's launches with the kernels."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import greedy
    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config("internvl2-76b"),
                              n_layers=VLM_LAYERS)
    tag = "[vlm internvl2-76b]"
    model = api.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag} published widths, {VLM_LAYERS} of 80 layers: "
          f"{sum(p.numel() for p in model.parameters()):,} params (bf16) "
          f"initialised in {time.perf_counter() - t_model:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(8)
    patches = torch.randn((1, cfg.n_patches, cfg.d_model), generator=gen,
                          device="cuda", dtype=torch.bfloat16)
    n, lo, hi = VLM_PROMPTS
    rng = np.random.default_rng(1)
    prompts = [torch.as_tensor(rng.integers(
        0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))[None],
        device="cuda") for _ in range(n)]

    def serve(prompt, backend, times=None):
        s = cfg.n_patches + prompt.shape[1]
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, caches = api.prefill(
                cfg, model, {"tokens": prompt, "patches": patches}, backend)
            tok, gap = greedy(logits[:, -1])
            out, gaps = [int(tok[0])], [float(gap[0])]
            if times is not None:
                times["prefill"].append(time.perf_counter() - t0)
            full = api.init_caches(cfg, 1, s + VLM_STEPS, device="cuda")
            for key, layer in full.items():
                for name, big in layer.items():
                    big[:, :, :s] = caches[key][name]
            for i in range(VLM_STEPS):
                t0 = time.perf_counter()
                step, full = api.decode_step(cfg, model, full, {
                    "tokens": tok[:, None].long(), "index": s + i}, backend)
                tok, gap = greedy(step[:, -1])
                out.append(int(tok[0]))
                gaps.append(float(gap[0]))
                if times is not None:
                    times["decode"].append(time.perf_counter() - t0)
        return logits, out, gaps

    runs = {}
    for backend in ("cuda", "reference"):
        serve(prompts[0][:, :16], backend)              # warm-up
        times = {"prefill": [], "decode": []}
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        res = [serve(p, backend, times) for p in prompts]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.LAUNCHES
        toks = sum(len(r[1]) for r in res)
        print(f"{tag} backend={backend}: {n} prompts of "
              f"{'/'.join(str(p.shape[1]) for p in prompts)} tokens after "
              f"{cfg.n_patches} patches: {toks} tokens in {wall:.2f} s "
              f"({toks / wall:.1f} tok/s); prefill "
              f"{1e3 * statistics.mean(times['prefill']):.1f} ms a prompt, "
              f"decode {1e3 * statistics.median(times['decode']):.1f} ms a "
              f"step; flash_attention launches {launches}")
        runs[backend] = (res, launches)
    want = VLM_LAYERS * n
    if runs["cuda"][1] != want or runs["reference"][1] != 0:
        raise SystemExit(f"{tag} flash_attention launches "
                         f"{runs['cuda'][1]} / {runs['reference'][1]}, "
                         f"expected {want} / 0")
    worst, same = 0.0, 0
    for i, ((lk, ok, _), (lr, orf, gr)) in enumerate(
            zip(runs["cuda"][0], runs["reference"][0])):
        if not torch.isfinite(lk).all():
            raise SystemExit(f"{tag} non-finite logits")
        worst = max(worst, float((lk - lr).abs().max()))
        if ok == orf:
            same += 1
            continue
        t = next(j for j, (a, b) in enumerate(zip(ok, orf)) if a != b)
        print(f"{tag} prompt {i} diverges at token {t}: plain top-2 gap "
              f"{gr[t]:.4g}")
        if gr[t] > LOGIT_TOL:
            raise SystemExit(f"{tag} divergence is not a near tie")
    if worst > LOGIT_TOL:
        raise SystemExit(f"{tag} first-token logits differ by {worst}")
    print(f"{tag} first-token logits, kernels vs plain: max abs diff "
          f"{worst:.4g} (tolerance {LOGIT_TOL}); streams identical for "
          f"{same} of {n} prompts")
    prompt = prompts[-1]
    s = cfg.n_patches + prompt.shape[1]
    caches = api.init_caches(cfg, 1, s + 1, device="cuda")
    step = {"tokens": prompt[:, :1], "index": s}
    with torch.inference_mode():
        traced(torch, lambda: float(api.prefill(cfg, model, {
            "tokens": prompt, "patches": patches})[0].sum()), tag,
            f"prefill of {cfg.n_patches} patches + {prompt.shape[1]} tokens",
            DEVICE_KERNEL[fa.__name__])
        traced(torch, lambda: float(api.decode_step(cfg, model, caches,
                                                    step)[0].sum()),
               tag, "decode step", DEVICE_KERNEL[fa.__name__])
    del model
    torch.cuda.empty_cache()
    print(f"{tag} wall {time.perf_counter() - t_model:.1f} s")
    return runs["cuda"][1]


def check_k4_audio(torch):
    """(e) K4 at whisper-small's audio shapes (B=1, H=12, D=64, bf16,
    non-causal): the encoder's self-attention over 1,500 frames and the
    decoder's cross attention from 448 tokens to them; against its plain
    version within 3e-2, timed in turns with SDPA, with the bound.  q is
    drawn at ``AUDIO_Q_SCALE`` times unit deviation so that the softmax is
    peaked and outputs are O(1) (at unit scores over 1,500 keys a mean
    |o| of 0.034 would sit under the limit itself); the limit must then
    catch the plain version with the last key left out."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import full_attention
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for sq, sk in WHISPER_AUDIO:
        def proj(s, scale=1.0):
            return (scale * torch.randn((1, s, 12, 64), generator=gen,
                                        device="cuda")).to(
                torch.bfloat16).transpose(1, 2)
        q, k, v = proj(sq, AUDIO_Q_SCALE), proj(sk), proj(sk)
        out = fa.flash_attention(q, k, v, causal=False)
        ref = full_attention(q, k, v, causal=False, q_block=512)
        short = full_attention(q, k[:, :, :-1], v[:, :, :-1], causal=False,
                               q_block=512)
        torch.cuda.synchronize()
        err, ok = worst_excess(out, ref, 3e-2)
        miss, blind = worst_excess(short, ref, 3e-2)
        name = f"whisper Sq={sq} Sk={sk} H=12 D=64 bf16 non-causal"
        print(f"[k4] {name}: plain mean |o| "
              f"{float(ref.float().abs().mean()):.3g}; leaving the last "
              f"key out moves it by up to {miss:.3g} "
              f"({'NOT caught' if blind else 'caught'} by the limit)")
        if blind:
            raise SystemExit(f"[k4] the limit on {name} cannot see a "
                             f"missing key")
        if not ok or not torch.isfinite(out).all():
            raise SystemExit(f"[k4] MISMATCH on {name}: max abs err {err}")
        plain = time_median_ms(torch, lambda: full_attention(
            q, k, v, causal=False, q_block=512), 3, reps=3)
        ms, lib, turns = k4_in_turns(
            torch, k4_raw_launch(torch, fa, q, k, v, False),
            sdpa_call(torch, q.contiguous(), k.contiguous(), v.contiguous(),
                      False))
        flops, nbytes = fa.work(1, 12, 12, sq, sk, 64, causal=False,
                                itemsize=2)
        bnd, by = bound(nbytes, flops, BF16_PEAK)
        print(f"[k4] {name}: max abs err {err:.3g} (atol = rtol = 3e-2); "
              f"kernel {ms * 1e3:.1f} us (turns {turns[0] * 1e3:.1f}/"
              f"{turns[3] * 1e3:.1f}), sdpa {lib * 1e3:.1f} us (turns "
              f"{turns[1] * 1e3:.1f}/{turns[2] * 1e3:.1f}), plain "
              f"{plain * 1e3:.1f} us, bound {bnd * 1e3:.2f} us ({by}; "
              f"kernel at {100 * bnd / ms:.1f}% of it, sdpa "
              f"{100 * bnd / lib:.1f}%)")
        rows[f"whisper_sq{sq}_sk{sk}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)
    return rows


def serve_twin_check(torch, fa):
    """(f) ``repro_torch.examples.serve_twin`` on cuda and on cpu, in this
    process: the same report; K4 in every prefill on cuda (12 requests x
    2 layers), none on cpu."""
    import contextlib
    import io
    from repro_torch.examples import serve_twin
    out = {}
    for device in ("cuda", "cpu"):
        fa.LAUNCHES = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve_twin.main(["--device", device])
        out[device] = (buf.getvalue(), fa.LAUNCHES,
                       time.perf_counter() - t0)
    (rep_g, n_g, wall_g), (rep_c, n_c, wall_c) = out["cuda"], out["cpu"]
    print(f"[serve_twin] python -m repro_torch.examples.serve_twin: cuda "
          f"{wall_g:.1f} s ({n_g} flash_attention launches), cpu "
          f"{wall_c:.1f} s; reports "
          f"{'identical' if rep_g == rep_c else 'DIFFER'}; last line: "
          f"{rep_g.strip().splitlines()[-1]}")
    if rep_g != rep_c or n_g != 24 or n_c != 0:
        raise SystemExit(f"[serve_twin] cuda report {rep_g!r} vs cpu "
                         f"{rep_c!r}; launches {n_g} / {n_c}")
    return n_g


def family_phase(torch, fa):
    """Phase 16: the moe, vlm and encdec families at published widths,
    K4 in their prefills.  Returns ({path: K4 launches}, K4 at whisper's
    audio shapes)."""
    t_phase = time.perf_counter()
    launches = {}
    launches["olmoe-1b-7b"] = serve_phase(
        torch, "olmoe-1b-7b", {fa: (16, 0)}, max_seq=FAMILY_MAX_SEQ,
        extra=lambda cfg, model: moe_dispatch_check(torch, cfg, model),
        **FAMILY_SERVE)[fa]
    launches["deepseek-v2-lite-16b"] = serve_phase(
        torch, "deepseek-v2-lite-16b", {fa: (0, 0)}, max_seq=FAMILY_MAX_SEQ,
        extra=lambda cfg, model: mla_decode_check(torch, cfg, model),
        layers=DEEPSEEK_LAYERS, **FAMILY_SERVE)[fa]
    launches["internvl2-76b"] = vlm_phase(torch, fa)
    launches["whisper-small"] = serve_phase(
        torch, "whisper-small", {fa: (36, 0)}, **WHISPER_SERVE)[fa]
    audio = check_k4_audio(torch)
    launches["serve_twin"] = serve_twin_check(torch, fa)
    print(f"[families] phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launches, audio


# --------------------------------------------------------------- phase 17
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 1024, 2
TRAIN_OPT = dict(peak_lr=3e-3, warmup_steps=1, total_steps=8)
PARITY_LAYERS = 2            # (b), (d): llama3.2-1b cut from 16 layers
PARITY_BATCH, PARITY_SEQ = 2, 256
PARITY_RTOL = 1e-5           # (b): loss and grad norm, cuda against cpu
PARITY_SCALE = 1e-4          # (b): each tensor's max |diff| over max |x|
#: (c): arch, the cut (``reduced``-style overrides), batch, tokens, and
#: the encoder's frames (whisper) or the vlm's patches
FAMILY_TRAIN = (
    ("olmoe-1b-7b", dict(n_layers=2), 2, 512, 0),          # of 16 layers
    ("deepseek-v2-lite-16b", dict(n_layers=2), 2, 512, 0),  # of 27
    ("rwkv6-7b", dict(n_layers=2), 2, 256, 0),             # of 32
    ("recurrentgemma-2b", dict(n_layers=3), 2, 512, 0),    # one period of 26
    ("internvl2-76b", dict(n_layers=2), 2, 512, 256),      # of 80; patches
    ("whisper-small", {}, 2, 448, 1500),                   # whole; frames
)
LM_TRAIN_CLI = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "20",
             "--log-every", "5"]
CLI_LOSS_TOL, CLI_GNORM_TOL = 2e-3, 5e-3   # tests/test_torch_train_cli.py's


def train_batch(cfg, batch, seq, seed, extra=0):
    """A ``SyntheticLM`` batch, with ``extra`` zero bf16 patches (vlm) or
    frames (encdec), as the training CLI feeds them."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    out = dict(SyntheticLM(DataConfig(cfg.vocab_size, seq, batch,
                                      seed=seed)).batch(0))
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((batch, extra, cfg.d_model),
                                     dtype=torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((batch, extra, cfg.d_model),
                                    dtype=torch.bfloat16)
    return out


def kernel_counts():
    from repro_torch.kernels import flash_attention, rglru, wkv6
    return flash_attention.LAUNCHES, rglru.LAUNCHES, wkv6.LAUNCHES


def init_state(torch, cfg, tag, **kw):
    from repro_torch.train import init_train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in state.params.values())
    print(f"{tag} {n:,} params ({kw.get('dtype', torch.bfloat16)}) drawn "
          f"on the card (the reference's init_params, threefry) in "
          f"{time.perf_counter() - t0:.2f} s")
    return state, n


def train_steps(torch, step, state, batches, tag, what):
    """``step`` over ``batches``, each timed (host clock, ending in the
    loss's read); returns (losses, walls, state)."""
    losses, walls = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        print(f"{tag} {what} step {i + 1} loss {losses[-1]:.4f} lr "
              f"{float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
              f"wall {walls[-1]:.3f} s")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{tag} non-finite loss: {losses}")
    return losses, walls, state


def train_full(torch):
    """(a) llama3.2-1b at published widths and full depth, bf16
    parameters and f32 moments, ``make_train_step`` with global batch 8 x
    1024 and accum 2: 8 steps on fresh ``SyntheticLM`` batches (finite
    losses; wall a step, tokens/s, peak memory, a traced step, the share
    of dense bf16 peak), then, from the same initial weights, 8 steps on
    one of those batches repeated: the loss must fall (mean of steps 7-8
    below step 1).  Fresh batches carry no signal a 1.2B-parameter model
    can take in 8 steps at a 128,256-token vocabulary: their loss stays
    at ln V or, at this learning rate, rises."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import OptimizerConfig, make_train_step
    tag = "[train llama3.2-1b]"
    cfg = get_config(TRAIN_ARCH)
    state, n = init_state(torch, cfg, tag)
    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT),
                           accum_steps=TRAIN_ACCUM, device="cuda")
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0))
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fresh, walls, state = train_steps(torch, step, state, batches, tag,
                                      "fresh batches:")
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = statistics.mean(walls[1:])
    flops = 8 * n * tokens      # 6·N·T, plus remat's extra forward 2·N·T
    print(f"{tag} steps 2-{TRAIN_STEPS}: {wall:.3f} s a step (min "
          f"{min(walls[1:]):.3f}, max {max(walls[1:]):.3f}), "
          f"{tokens / wall:,.0f} tokens/s; peak memory "
          f"{peak / 2**30:.1f} GiB; 8·N·T = {flops:.3e} FLOP a step, "
          f"{100.0 * flops / wall / BF16_PEAK:.1f}% of dense bf16 peak "
          f"(989 TFLOP/s at 700 W)")
    holder = [state]

    def one():
        holder[0], metrics = step(holder[0], batches[0])
        return float(metrics["loss"])

    trace = traced(torch, one, tag, "one train step",
                   ("gemm", "nvjet", "elementwise"))
    del holder, state
    torch.cuda.empty_cache()
    state, _ = init_state(torch, cfg, tag)
    same, _, state = train_steps(torch, step, state,
                                 [batches[0]] * TRAIN_STEPS, tag,
                                 "one batch repeated:")
    if statistics.mean(same[-2:]) >= same[0]:
        raise SystemExit(f"{tag} the loss did not fall: {same}")
    print(f"{tag} loss on one batch: {same[0]:.4f} -> "
          f"{statistics.mean(same[-2:]):.4f} (mean of steps 7-8); fresh "
          f"batches: {fresh[0]:.4f} -> {statistics.mean(fresh[-2:]):.4f}")
    del state, step
    torch.cuda.empty_cache()
    return dict(fresh_losses=fresh, same_batch_losses=same, wall_s=wall,
                tokens_s=tokens / wall, peak_gib=peak / 2**30,
                peak_bytes=peak, before_bytes=before, n_params=n,
                bf16_share=flops / wall / BF16_PEAK,
                busy_us=trace["busy_us"], kernels=trace["kernels"],
                wall_traced_us=trace["wall_us"])


def _grads(torch, cfg, params, batch, device):
    """(loss, {name: gradient}) of one batch on ``device``."""
    from repro_torch.models import api
    from repro_torch.train.train_step import batch_on
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = api.train_loss(cfg, leaves,
                             batch_on(batch, torch.device(device)))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def worst_scaled(a, b, where=None):
    """max over tensors of max |a - b| / max |b| (b on the CPU), over the
    elements ``where[name]`` marks when given; returns (that, name)."""
    worst = (0.0, "")
    for k in b:
        scale = float(b[k].detach().abs().max()) or 1.0
        d = (a[k].detach().cpu() - b[k].detach()).abs()
        if where is not None:
            d = d[where[k]]
        worst = max(worst, (float(d.max()) / scale if d.numel() else 0.0, k))
    return worst


def train_parity(torch):
    """(b) one step of llama3.2-1b's published widths cut to 2 of 16
    layers, f32 (TF32 off), batch 2 x 256, on the card and on the CPU
    from the same weights (drawn on the card, copied): loss and grad
    norm within rtol 1e-5; every gradient and both moments after the
    step within 1e-4 of their tensor's max |x|; the parameters within
    1e-4 of max |p| wherever |g| is at least 1e-3 of its tensor's max
    |g|.  Below that, AdamW's first step, lr·g/(|g| + eps), magnifies
    the card's and the CPU's last-bit gradient differences (for |g| near
    eps up to lr itself): there the parameters must be within 2·lr,
    the bound of one step's update."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train import (OptimizerConfig, TrainState,
                                   make_train_step)
    from repro_torch.train.optimizer import init_opt_state, lr_at
    tag = "[train parity]"
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PARITY_LAYERS)
    gpu, _ = init_state(torch, cfg, tag, dtype=torch.float32)
    params = {k: v.detach().to("cpu", copy=True).requires_grad_(True)
              for k, v in gpu.params.items()}
    cpu = TrainState(params, init_opt_state(params), None)
    batch = train_batch(cfg, PARITY_BATCH, PARITY_SEQ, seed=5)
    t0 = time.perf_counter()
    loss_g, grads_g = _grads(torch, cfg, gpu.params, batch, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_c, grads_c = _grads(torch, cfg, cpu.params, batch, "cpu")
    t2 = time.perf_counter()
    g_err, g_key = worst_scaled(grads_g, grads_c)
    firm = {k: g.abs() >= 1e-3 * g.abs().max() for k, g in grads_c.items()}
    del grads_g, grads_c
    opt = OptimizerConfig(**TRAIN_OPT)
    gpu, m_g = make_train_step(cfg, opt, accum_steps=1,
                               device="cuda")(gpu, batch)
    cpu, m_c = make_train_step(cfg, opt, accum_steps=1,
                               device="cpu")(cpu, batch)
    lr = float(lr_at(opt, torch.tensor(1)))
    errs = {what: worst_scaled(a, b, mask) for what, a, b, mask in (
        ("params", gpu.params, cpu.params, firm),
        ("mu", gpu.opt.mu, cpu.opt.mu, None),
        ("nu", gpu.opt.nu, cpu.opt.nu, None))}
    p_abs = max(float((gpu.params[k].detach().cpu() - p.detach()).abs()
                      .max()) for k, p in cpu.params.items())
    n_firm = sum(int(m.sum()) for m in firm.values())
    n_all = sum(m.numel() for m in firm.values())
    rel = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k]))
           for k in ("loss", "grad_norm")}
    print(f"{tag} loss cuda {float(loss_g):.7f} cpu {float(loss_c):.7f}; "
          f"step: loss rel diff {rel['loss']:.2e}, grad norm "
          f"{float(m_g['grad_norm']):.6f} / {float(m_c['grad_norm']):.6f} "
          f"(rel {rel['grad_norm']:.2e}); gradients: worst {g_err:.2e} of "
          f"max |g| ({g_key}); after the step: "
          + ", ".join(f"{w} {e:.2e} ({k})" for w, (e, k) in errs.items())
          + f" (params over the {n_firm:,} of {n_all:,} elements with |g| "
          f">= 1e-3 max |g|; over all: max |diff| {p_abs:.2e}, limit "
          f"2·lr = {2 * lr:.1e}); forward+backward cuda {t1 - t0:.2f} s, "
          f"cpu {t2 - t1:.2f} s")
    if (max(rel.values()) > PARITY_RTOL or g_err > PARITY_SCALE
            or any(e > PARITY_SCALE for e, _ in errs.values())
            or p_abs > 2 * lr):
        raise SystemExit(f"{tag} cuda and cpu part past the limits")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(loss_rel=rel["loss"], grad_norm_rel=rel["grad_norm"],
                grad_scaled=g_err, params_abs=p_abs,
                **{f"{w}_scaled": e for w, (e, _) in errs.items()})


def train_families(torch):
    """(c) one bf16 step of each other family, cut as ``FAMILY_TRAIN``
    says, each model freed before the next: loss finite, grad norm
    finite and > 0; the MoE's aux terms finite and in the total."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train import OptimizerConfig, make_train_step
    out = {}
    for arch, cut, b, s, extra in FAMILY_TRAIN:
        tag = f"[train {arch}]"
        cfg = dataclasses.replace(get_config(arch), **cut)
        what = "patches" if cfg.family == "vlm" else "frames"
        print(f"{tag} cut: {cut or 'whole'}; batch {b} x {s} tokens"
              + (f", {extra} zero {what}" if extra else ""))
        state, n = init_state(torch, cfg, tag)
        step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT),
                               accum_steps=1, device="cuda")
        batch = train_batch(cfg, b, s, seed=1, extra=extra)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        wall = time.perf_counter() - t0
        line = (f"{tag} loss {m['loss']:.4f} (xent {m['xent']:.4f}) grad "
                f"norm {m['grad_norm']:.4f}, wall {wall:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        ok = (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              and m["grad_norm"] > 0)
        if cfg.family == "moe":
            line += (f"; moe_aux {m['moe_aux']:.4e} moe_z {m['moe_z']:.4e} "
                     f"moe_dropped {m['moe_dropped']:.0f}")
            total = m["xent"] + m["moe_aux"] + m["moe_z"]
            ok = ok and all(math.isfinite(m[k]) for k in ("moe_aux", "moe_z"))
            ok = ok and abs(m["loss"] - total) <= 1e-6 * abs(total)
        print(line)
        if not ok:
            raise SystemExit(f"{tag} failed: {m}")
        out[arch] = dict(loss=m["loss"], grad_norm=m["grad_norm"],
                         wall_s=wall, params=n)
        del state, step
        torch.cuda.empty_cache()
    return out


def train_compress(torch):
    """(d) ``--compress`` on (b)'s cut model in bf16: ``quantize`` on the
    card bitwise ``quantize`` on the CPU on the same f32 gradients (every
    tensor's), then one compressed step; ``compression_err``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import compression
    tag = "[train compress]"
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PARITY_LAYERS)
    state, _ = init_state(torch, cfg, tag, compress=True)
    batch = train_batch(cfg, PARITY_BATCH, PARITY_SEQ, seed=6)
    _, grads = _grads(torch, cfg, state.params, batch, "cuda")
    n = differ = 0
    for g in grads.values():
        g = g.float()
        a, b = compression.quantize(g), compression.quantize(g.cpu())
        n += g.numel()
        differ += int((a.q.cpu() != b.q).sum()) + int(
            (a.scale.cpu().view(torch.int32) != b.scale.view(torch.int32))
            .sum())
    del grads
    state, m = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT),
                               compress=True, accum_steps=1,
                               device="cuda")(state, batch)
    err = float(m["compression_err"])
    print(f"{tag} quantize card vs cpu: {differ} of {n:,} gradient "
          f"elements and scales differ; one compressed step: loss "
          f"{float(m['loss']):.4f}, compression_err {err:.3e}")
    if differ or not math.isfinite(err) or not math.isfinite(
            float(m["loss"])):
        raise SystemExit(f"{tag} failed")
    del state
    torch.cuda.empty_cache()
    return dict(quantize_differing=differ, compression_err=err)


def train_cli_run(argv):
    """``repro_torch.launch.train`` in this process: (stdout, wall)."""
    import contextlib
    import io
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def cli_lines(out):
    """{step: (loss, lr, gnorm)} of the CLI's log lines."""
    rows = {}
    for line in out.splitlines():
        f = line.split()
        if f[:1] == ["step"] and "loss" in f:
            rows[int(f[1])] = (float(f[3]), f[5], float(f[7]))
    return rows


def cli_agree(got, want, steps):
    got, want = cli_lines(got), cli_lines(want)
    if sorted(got) != list(steps) or sorted(want) != list(steps):
        return False, float("inf")
    worst = max(abs(got[s][0] - want[s][0]) for s in steps)
    ok = all(abs(got[s][0] - want[s][0]) <= CLI_LOSS_TOL
             and got[s][1] == want[s][1]
             and abs(got[s][2] - want[s][2]) <= CLI_GNORM_TOL
             for s in steps)
    return ok, worst


def train_cli_phase():
    """(e) the CLI at smoke size on cuda and cpu: the same lines within
    the tests' bf16 tolerance; a run checkpointed at steps 10 and 20
    under ``build/``, step 20's checkpoint removed and relaunched,
    prints the uninterrupted run's lines for steps 15 and 20."""
    import shutil
    tag = "[train cli]"
    ckpt = os.path.join(WORK, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    with_ckpt = ["--ckpt-dir", ckpt, "--ckpt-every", "10"]
    cuda, wall_g = train_cli_run(LM_TRAIN_CLI + with_ckpt)
    cpu, wall_c = train_cli_run(LM_TRAIN_CLI + ["--device", "cpu"])
    ok, worst = cli_agree(cuda, cpu, (5, 10, 15, 20))
    print(f"{tag} python -m repro_torch.launch.train "
          f"{' '.join(LM_TRAIN_CLI)}: cuda {wall_g:.1f} s, cpu "
          f"{wall_c:.1f} s; "
          f"losses within {worst:.1e} (limit {CLI_LOSS_TOL}): "
          f"{'agree' if ok else 'DIFFER'}; cuda's last step: "
          f"{cuda.strip().splitlines()[-2]}")
    shutil.rmtree(os.path.join(ckpt, "step_000000020"))
    resumed, _ = train_cli_run(LM_TRAIN_CLI + with_ckpt)
    r_ok, r_worst = cli_agree(resumed, cuda.split("step    10")[1], (15, 20))
    same = all(cli_lines(resumed)[s] == cli_lines(cuda)[s] for s in (15, 20))
    print(f"{tag} relaunched on the step-10 checkpoint: "
          f"{'restored checkpoint at step 10' in resumed}; steps 15 and 20 "
          f"{'identical to' if same else f'within {r_worst:.1e} of'} the "
          f"uninterrupted run's")
    if not (ok and r_ok and "restored checkpoint at step 10" in resumed):
        raise SystemExit(f"{tag} failed:\n{cuda}\n{cpu}\n{resumed}")
    return dict(cuda_cpu_worst_loss=worst, resume_identical=same)


def lm_training_phase(torch):
    """Phase 17: LM training on the card (no kernel on its path: the
    counts of K2, K3 and K4 must not move)."""
    t_phase = time.perf_counter()
    before = kernel_counts()
    out = dict(full=train_full(torch), parity=train_parity(torch),
               families=train_families(torch),
               compress=train_compress(torch), cli=train_cli_phase())
    if kernel_counts() != before:
        raise SystemExit(f"[train] a kernel launched on the training path: "
                         f"{before} -> {kernel_counts()}")
    print(f"[train] phase 17: {time.perf_counter() - t_phase:.1f} s; "
          f"no kernel launched (K4, K2, K3 counts unmoved)")
    return out


# --------------------------------------------------------------- phase 18
#: (b): the cells run for real on the card, each cut to fit: (arch, shape,
#: batch, layers or None for all); and (a)'s cells run on meta only: a
#: prefill and a decode cell a family, and long_500k for a long-context
#: arch.  (a) runs no train cell: those took 35 s of the host's CPU on the
#: card's machine (PERF.md §6, PR 23), which ``dryrun --all`` and the CPU
#: tests cover; (c) runs one on meta and on the card.
DRY_CARD = (("llama3.2-1b", "prefill_32k", 8, None),
            ("llama3.2-1b", "decode_32k", 32, None),
            ("recurrentgemma-2b", "prefill_32k", 1, None),
            ("rwkv6-7b", "prefill_32k", 1, RWKV_LAYERS))
DRY_META = (("internvl2-76b", "prefill_32k"),
            ("internvl2-76b", "decode_32k"),
            ("olmoe-1b-7b", "prefill_32k"), ("olmoe-1b-7b", "decode_32k"),
            ("rwkv6-7b", "decode_32k"), ("recurrentgemma-2b", "decode_32k"),
            ("whisper-small", "prefill_32k"), ("whisper-small", "decode_32k"),
            ("recurrentgemma-2b", "long_500k"))
#: (b), (c): |card peak - meta peak| allowed, over the bytes the step adds
#: to its inputs (PERF.md §6, PR 23: set before the first card run)
DRY_PEAK_RTOL, DRY_PEAK_ATOL = 0.05, 256 * 2**20
#: the dry run's name of each kernel module's count
DRY_KERNELS = {"flash_attention": "repro_torch.kernels.flash_attention",
               "wkv6": "repro_torch.kernels.wkv6",
               "rglru": "repro_torch.kernels.rglru"}


def dry_spec(arch, shape, batch=None, layers=None, seq=None, **overrides):
    """(spec, cell) of the dry run's cell ``arch`` x ``shape``, its batch,
    length and depth cut as given (``None``: the cell's own); other
    config fields from ``overrides``."""
    from repro_torch.configs import SHAPES, ShapeCell, get_config
    from repro_torch.launch.specs import cell_inputs
    cfg = get_config(arch)
    if layers is not None:
        overrides["n_layers"] = layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    base = SHAPES[shape]
    cell = ShapeCell(base.name, base.seq_len if seq is None else seq,
                     base.global_batch if batch is None else batch, base.kind)
    return cell_inputs(arch, cell, cfg), cell


def launch_counts():
    return {name: sys.modules[mod].LAUNCHES
            for name, mod in DRY_KERNELS.items()}


def dry_meta(spec, cell, tag):
    """The step on meta under the counter: (counter, roofline, seconds)."""
    from repro_torch.launch import cost, dryrun
    t0 = time.perf_counter()
    before = launch_counts()
    ctr, out = dryrun.count_step(spec, cell)
    del out
    secs = time.perf_counter() - t0
    if launch_counts() != before:
        raise SystemExit(f"{tag} a kernel launched on meta: {before} -> "
                         f"{launch_counts()}")
    return ctr, cost.Roofline(ctr.flops, ctr.bytes).finalize(), secs


def gib(n):
    return f"{n / 2**30:.2f} GiB"


def on_card(torch, spec):
    """``spec`` with every meta tensor a zero tensor on the card (the
    counts and the peak do not depend on values; drawing weights costs
    ~1.2 ns a parameter)."""
    from torch.utils._pytree import tree_map
    args = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device="cuda")
                    if isinstance(t, torch.Tensor) else t, spec.args)
    return spec._replace(args=args)


def peak_agrees(card, meta):
    return abs(card - meta) <= DRY_PEAK_RTOL * meta + DRY_PEAK_ATOL


def dry_card_cell(torch, arch, shape, batch, layers):
    """(b) One cell on meta, then on the card (zero weights and inputs):
    the card's launches == the meta run's kernel calls, the counter's
    FLOPs on the card == meta's, the card's peak above its inputs within
    the tolerance of meta's; then timed outside the counter (the second of
    two calls) against the roofline."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    cut = f"batch {batch} of {SHAPES[shape].global_batch}" + (
        f", {layers} of its layers" if layers else "")
    tag = f"[dryrun {arch} {shape}]"
    spec, cell = dry_spec(arch, shape, batch, layers)
    meta, rl, meta_s = dry_meta(spec, cell, tag)
    card = on_card(torch, spec)
    del spec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_mem = torch.cuda.memory_allocated()
    before = launch_counts()
    ctr, out = dryrun.count_step(card, cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before_mem
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    launched = {k: v for k, v in launched.items() if v}
    del out
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dryrun.run_step(card, cell)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    del card
    torch.cuda.empty_cache()
    meta_peak = meta.peak - meta.base
    roof = max(rl.t_compute, rl.t_memory)
    print(f"{tag} ({cut}) meta {meta_s:.1f} s: {meta.flops:.6e} FLOP, "
          f"{meta.bytes:.6e} B, kernel calls {meta.kernel_calls}, peak "
          f"{gib(meta.peak)} ({gib(meta.base)} inputs + {gib(meta_peak)}); "
          f"card: launches {launched}, counter {ctr.flops:.6e} FLOP, "
          f"{ctr.bytes:.6e} B, peak above inputs {gib(peak)} (meta "
          f"{gib(meta_peak)}, {100 * (peak / meta_peak - 1):+.2f}%); wall "
          f"{walls[-1] * 1e3:.1f} ms (first {walls[0] * 1e3:.1f}) against "
          f"the roofline's {roof * 1e3:.1f} ms (Tc {rl.t_compute * 1e3:.1f}"
          f", Tm {rl.t_memory * 1e3:.1f}, {rl.bottleneck}-bound): "
          f"{100 * roof / walls[-1]:.1f}% of it")
    if launched != meta.kernel_calls or ctr.kernel_calls != meta.kernel_calls:
        raise SystemExit(f"{tag} launches {launched} (counter "
                         f"{ctr.kernel_calls}) != meta kernel calls "
                         f"{meta.kernel_calls}")
    if ctr.flops != meta.flops:
        raise SystemExit(f"{tag} FLOPs on the card {ctr.flops!r} != meta "
                         f"{meta.flops!r}")
    if not peak_agrees(peak, meta_peak):
        raise SystemExit(f"{tag} peak {peak} B on the card, meta "
                         f"{meta_peak} B: past {DRY_PEAK_RTOL:.0%} + "
                         f"{gib(DRY_PEAK_ATOL)}")
    return dict(launches=launched, flops=meta.flops, bytes=meta.bytes,
                meta_s=meta_s, peak_card=peak, peak_meta=meta_peak,
                wall_s=walls[-1], roofline_s=roof,
                bound=rl.bottleneck)


def dry_train_check(torch, trained):
    """(c) Phase 17 (a)'s configuration (llama3.2-1b, 8 x 1024 tokens,
    accum 2) on meta against phase 17's measured peak above its inputs,
    and against the counter around one step of it on the card (zero
    state): FLOPs equal, no kernel launched, the peak within the
    tolerance."""
    from repro_torch.launch import dryrun
    tag = "[dryrun train]"
    spec, cell = dry_spec(TRAIN_ARCH, "train_4k", TRAIN_BATCH,
                          seq=TRAIN_SEQ, accum_steps=TRAIN_ACCUM)
    meta, rl, meta_s = dry_meta(spec, cell, tag)
    card = on_card(torch, spec)
    del spec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_mem = torch.cuda.memory_allocated()
    before = launch_counts()
    ctr, out = dryrun.count_step(card, cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before_mem
    del out, card
    torch.cuda.empty_cache()
    meta_peak = meta.peak - meta.base
    p17 = trained["peak_bytes"] - trained["before_bytes"]
    print(f"{tag} llama3.2-1b, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, accum "
          f"{TRAIN_ACCUM}: meta {meta_s:.1f} s, {meta.flops:.6e} FLOP "
          f"(8·N·T {8 * trained['n_params'] * TRAIN_BATCH * TRAIN_SEQ:.6e})"
          f", {meta.bytes:.6e} B, peak {gib(meta.peak)} ({gib(meta.base)} "
          f"inputs + {gib(meta_peak)}); one step on the card under the "
          f"counter: {ctr.flops:.6e} FLOP, peak above inputs {gib(peak)}; "
          f"phase 17 (a): peak {gib(trained['peak_bytes'])}, "
          f"{gib(p17)} above its state ({100 * (p17 / meta_peak - 1):+.2f}%"
          f" of meta); roofline {max(rl.t_compute, rl.t_memory):.3f} s a "
          f"step ({rl.bottleneck}-bound) against phase 17's "
          f"{trained['wall_s']:.3f} s")
    if launch_counts() != before or ctr.kernel_calls or meta.kernel_calls:
        raise SystemExit(f"{tag} a kernel launched on the training path")
    if ctr.flops != meta.flops:
        raise SystemExit(f"{tag} FLOPs on the card {ctr.flops!r} != meta "
                         f"{meta.flops!r}")
    for what, got in (("the counted step", peak), ("phase 17 (a)", p17)):
        if not peak_agrees(got, meta_peak):
            raise SystemExit(f"{tag} peak of {what} {got} B, meta "
                             f"{meta_peak} B: past {DRY_PEAK_RTOL:.0%} + "
                             f"{gib(DRY_PEAK_ATOL)}")
    return dict(flops=meta.flops, peak_meta=meta_peak, peak_card=peak,
                peak_phase17=p17, meta_s=meta_s)


def dry_run_phase(torch, trained):
    """Phase 18: the one-GPU dry run (``launch/dryrun.py``) on meta, held
    against the card.  (a) its record line for (b)'s cells and a prefill
    and a decode cell a family; (b) four cells for real on the card, cut to
    fit; (c) phase 17 (a)'s training configuration."""
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    for arch, shape in DRY_META + tuple((a, s) for a, s, _, _ in DRY_CARD):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape)
        print(f"[dryrun a] {dryrun.fmt_cell(rec)} kernel calls "
              f"{rec.get('kernel_calls')} ({time.perf_counter() - t0:.1f} s)")
        if rec["status"] != "ok":
            raise SystemExit(f"[dryrun a] {arch} {shape}: {rec['status']}")
    cells = {f"{a} {s}": dry_card_cell(torch, a, s, b, n)
             for a, s, b, n in DRY_CARD}
    train = dry_train_check(torch, trained)
    print(f"[dryrun] phase 18: {time.perf_counter() - t_phase:.1f} s")
    return cells, train


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from repro_torch.core.engine import DrainEngine
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import policy_eval as pe
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import wkv6 as wk

    t_start = time.perf_counter()
    print(f"[card] {card_line()}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    logs = build_kernels()
    engine = DrainEngine(backend="cuda", device="cuda")
    snapshot = polaris_snapshot(engine)
    k1, drain_inputs = kernel_vs_plain(torch, engine, snapshot)
    check_cosim(pe)
    launches, mirrors, _, _ = polaris_cycles(torch, engine, pe)
    profile_cycle(torch, engine, snapshot)
    k1s_launches, k1s = check_k1_shared(torch, snapshot, mirrors)
    report_k4_plan(logs)
    k4 = check_k4(torch)
    k4_local = check_k4_local(torch)
    k3 = check_k3(torch)
    k2 = check_k2(torch)
    llama = serve_phase(torch, "llama3.2-1b", {fa: (16, 0)}, n_req=8,
                        slots=4, max_seq=2048, lo=128, hi=1024, max_new=16)
    rwkv = serve_phase(torch, "rwkv6-7b", {wk: (RWKV_LAYERS, 0)}, n_req=4,
                       slots=2, max_seq=1024, lo=128, hi=768, max_new=8,
                       layers=RWKV_LAYERS)
    rgemma = serve_phase(torch, "recurrentgemma-2b", {rg: (18, 18),
                                                      fa: (8, 0)},
                         n_req=4, slots=2, max_seq=4096, lo=256, hi=3072,
                         max_new=8, min_longest=2048)
    replay = replay_phase(torch, pe, snapshot)
    mc = monte_carlo_phase(torch, pe, snapshot, engine)
    learn = learning_phase(torch, pe, engine)
    fleet_pass, fleet = fleet_phase(torch, pe, snapshot, mc)
    families, k4_audio = family_phase(torch, fa)
    trained = lm_training_phase(torch)
    dry, _ = dry_run_phase(torch, trained["full"])
    if "--parent" in sys.argv:
        compare_parent(torch, sys.argv[sys.argv.index("--parent") + 1],
                       drain_inputs)
    if "--k1-phases" in sys.argv:
        k1_phases(torch, drain_inputs)
    if "--k2-phases" in sys.argv:
        k2_phases(torch)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    k4_err = max([k4["max_abs_err"]]
                 + [r["max_abs_err"] for r in k4_local.values()]
                 + [r["max_abs_err"] for r in k4_audio.values()])
    dry_paths = {name: {f"dryrun {cell}": rec["launches"][name]
                        for cell, rec in dry.items()
                        if rec["launches"].get(name)}
                 for name in DRY_KERNELS}
    local = {key: k4_local[2048][key] for key in
             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(card_line())
    print(json.dumps({"kernels": [
        dict(K1, launches=launches + replay["launches"]
             + sum(mc["launches_by_path"].values())
             + sum(learn["launches_by_path"].values())
             + sum(fleet.values()), **k1,
             library_ms=None,
             launches_by_path={"polaris_cycles": launches,
                               "polaris_replay_grid": replay["launches"],
                               **mc["launches_by_path"],
                               **learn["launches_by_path"], **fleet},
             replay_mean_us=replay["k1_mean_us"],
             replay_pass=replay["k1_pass"], fan_pass=mc["fan_pass"],
             fan_grid_pass=mc["fan_grid_pass"],
             fleet_pass=fleet_pass,
             training_pass=learn["training_pass"]),
        dict(K1S, launches=k1s_launches, **k1s),
        dict(K2, launches=rgemma[rg] + sum(dry_paths["rglru"].values()),
             **k2, launches_by_path={"recurrentgemma-2b": rgemma[rg],
                                     **dry_paths["rglru"]}),
        dict(K3, launches=rwkv[wk] + sum(dry_paths["wkv6"].values()),
             **k3, launches_by_path={"rwkv6-7b": rwkv[wk],
                                     **dry_paths["wkv6"]}),
        dict(K4, launches=llama[fa] + rgemma[fa] + sum(families.values())
             + sum(dry_paths["flash_attention"].values()),
             **{**k4, "max_abs_err": k4_err},
             launches_by_path={"llama3.2-1b": llama[fa],
                               "recurrentgemma-2b": rgemma[fa],
                               **families, **dry_paths["flash_attention"]},
             recurrentgemma_local_s2048=local, **k4_audio)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
