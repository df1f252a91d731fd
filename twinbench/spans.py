"""The arithmetic of the readers of the program's own spans and counters
(``repro_torch.core.telemetry.SPANS``: ``grid`` roots holding a
``replay`` span with one ``replay.read`` a block; counters
``replay.steps`` and ``replay.iters``).  The window's grids are the ``grid`` roots that start
after set-up, the first as many as the window has units: the warm grid
starts inside set-up and the traced unit after the window.  Each reader
returns None where the program recorded nothing to read (a program
without the recorder, a run with no grid)."""
from __future__ import annotations

import statistics
from typing import List, Optional


def _recorder():
    from repro_torch.core import telemetry
    return getattr(telemetry, "SPANS", None)


def window_grids(run) -> List:
    """The window's ``grid`` trees, in the order they started."""
    rec, n = _recorder(), len(run.rec.spans.get("unit", ()))
    if rec is None or not n:
        return []
    t0 = (run.t_start + run.setup_s) * 1e9
    grids = [t for t in list(rec.roots)
             if t.root.name == "grid" and t.root.start_ns >= t0]
    return sorted(grids, key=lambda t: t.root.start_ns)[:n]


def _total(grids, counter: str) -> int:
    return sum(t.counts().get(counter, 0) for t in grids)


def _per_step_ms(run, ns_of) -> Optional[float]:
    grids = window_grids(run)
    steps = _total(grids, "replay.steps")
    if not steps:
        return None
    return 1e-6 * sum(ns_of(t) for t in grids) / steps


def dispatch_ms(run) -> Optional[float]:
    """The host's time a step outside the block reads: the ``replay``
    spans' self time over the steps dispatched."""
    return _per_step_ms(run, lambda t: sum(t.self_ns(r)
                                           for r in t.named("replay")))


def wait_ms(run) -> Optional[float]:
    """The host's wait for the card a step: the ``replay.read`` spans
    over the steps dispatched."""
    return _per_step_ms(run, lambda t: sum(r.ns
                                           for r in t.named("replay.read")))


def prep_ms(run) -> Optional[float]:
    """A grid's time outside its replay loop: uploads, hoisting, metrics
    and selection."""
    grids = window_grids(run)
    if not grids:
        return None
    return 1e-6 * statistics.fmean(
        t.root.ns - sum(r.ns for r in t.named("replay")) for t in grids)


def useful_steps(run) -> Optional[float]:
    """Per cent of the steps dispatched that had work left (the rest are
    the last block's tail after the flag fell)."""
    grids = window_grids(run)
    steps = _total(grids, "replay.steps")
    if not steps:
        return None
    return 100.0 * _total(grids, "replay.iters") / steps


def steps_s(tree, lo: int, hi: int, block: int) -> Optional[float]:
    """Seconds the host took over steps [lo, hi) of the tree's replay,
    untraced: each block's dispatch and read (from the end of the read
    before it to the end of its own; the read waits for the whole
    block, so this is the card's wall for the block), pro rata to the
    block's steps in the range.  None when the replay ran fewer steps."""
    replays = tree.named("replay")
    steps = tree.counts().get("replay.steps", 0)
    if len(replays) != 1 or steps < hi:
        return None
    total, prev = 0, replays[0].start_ns
    for i, r in enumerate(tree.children(replays[0])):
        a, b = i * block, min((i + 1) * block, steps)
        inside = min(b, hi) - max(a, lo)
        if inside > 0:
            total += (r.end_ns - prev) * inside / (b - a)
        prev = r.end_ns
    return 1e-9 * total


def idle_untraced(run) -> Optional[float]:
    """Per cent of the traced window's steps in which the card would
    idle untraced: 1 − the window's device busy time over the same
    steps' time in the window's untraced grids (their mean).  None where
    the busy time exceeds that time: the two were not of the same
    work."""
    from repro_torch.core.des import REPLAY_BLOCK
    prof, window = run.profile, run.cell.traffic.get("profile")
    if not prof or not window:
        return None
    lo = window["start"] + window["warm"]
    hi = lo + window["active"]
    times = [s for s in (steps_s(t, lo, hi, REPLAY_BLOCK)
                         for t in window_grids(run)) if s]
    if not times or prof["busy_s"] > statistics.fmean(times):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / statistics.fmean(times))
