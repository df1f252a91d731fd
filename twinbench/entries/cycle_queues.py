"""The live twin's decision cycle over a backlog drawn from a batch
system's queue table (``gen/queues.py``).

``entries/cycle.py``'s closed loop, unchanged: the same stand-in
scheduler, timed unit (one cycle through ``SchedTwin.pump()``), episodes
of ``episode_cycles`` whole cycles, reference and check.  Only the
episode's backlog differs: jobs of the configuration's queues, drawn by
the mix's shares and arriving interleaved.  The fan may state its
``failure_frac`` (the most of the cluster a member loses; 0.25, the
default of both, otherwise), which the program's ``FanSpec`` and the
reference both read.  Each cycle also counts its forks, policies ×
futures, for ``forks_per_s``.
"""
from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from twinbench.gen import queues, scheduler
from twinbench.harness import load_module

CYCLE = load_module(Path(__file__).resolve().parents[1], "entries", "cycle")
# the decision cycle's reference, comparison and check, as they ship
reference, compare, check = CYCLE.reference, CYCLE.compare, CYCLE.check


def draw_episode(cfg: Dict, tr: Dict, seed: int, e: int):
    """Episode ``e``'s stand-in scheduler (holding its backlog) and fan."""
    rng = np.random.default_rng([seed, e])
    backlog = queues.backlog(tr["backlog"], cfg, rng)
    fan = dict(tr["fan"], seed=int(rng.integers(0, 2**31)))
    sched = scheduler.StandIn({k: v[0] for k, v in backlog.items()},
                              cfg["total_nodes"], tr["obits"])
    return sched, fan


def _episode(st) -> None:
    from repro_torch.core.events import EventBus
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.twin import SchedTwin

    cfg, tr = st.cfg, st.tr
    sched, fan = draw_episode(cfg, tr, st.seed, len(st.fans))

    def on_qrun(jobs: List[int], t: float) -> None:
        st.t_qrun = time.perf_counter()
        sched.qrun(jobs, t)

    st.sched, st.cycles = sched, 0
    st.fans.append(fan)
    st.twin = SchedTwin(
        bus=EventBus(), qrun=on_qrun, total_nodes=cfg["total_nodes"],
        max_jobs=cfg["max_jobs"], pool=cfg["pool"], objective=tr["goal"],
        engine=st.engine, device=st.device,
        fan=FanSpec(n=fan["n"], runtime_noise=fan["runtime_noise"],
                    failure_prob=fan["failure_prob"],
                    failure_frac=fan.get("failure_frac", 0.25),
                    seed=fan["seed"]))


def _cycle(st, rec) -> None:
    CYCLE._cycle(st, rec)
    cyc = st.log[-1][3]
    rec.count("forks", len(cyc.costs) * cyc.fan_size)


def setup(run):
    from repro_torch.core.engine import DrainEngine
    from twinbench.harness import Recorder

    st = SimpleNamespace(cfg=run.cell.config, tr=run.cell.traffic,
                         seed=run.seed, device=run.device, fans=[], log=[],
                         t_qrun=None, engine=DrainEngine(device=run.device))
    _episode(st)
    for _ in range(st.tr["warm_cycles"]):
        _cycle(st, Recorder())
    st.n_warm = len(st.log)
    return st


def unit(st, rec) -> int:
    """One episode: a fresh twin on the next backlog, run for its cycles."""
    _episode(st)
    for _ in range(st.tr["episode_cycles"]):
        _cycle(st, rec)
    return st.tr["episode_cycles"]
