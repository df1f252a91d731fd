"""The arithmetic of the readers of the decision cycle's spans and
counters (``repro_torch.core.telemetry.SPANS``: ``decision`` roots, one
a cycle, holding a ``drain`` span with one ``drain.read`` around each
iteration's read of the loop condition; counter ``drain.steps``, the
iterations dispatched).  The window's decisions are the ``decision``
roots that start after set-up, the first as many as the window's cycles:
the warm cycles decide inside set-up and the traced unit's after the
window.  Each reader returns None where the program recorded nothing to
read (a program without these spans, a run with no cycle)."""
from __future__ import annotations

import statistics
from typing import List, Optional

from twinbench.spans import _recorder


def window_decisions(run) -> List:
    """The window's ``decision`` trees, in the order they started."""
    rec, n = _recorder(), len(run.rec.spans.get("unit", ()))
    if rec is None or not n:
        return []
    t0 = (run.t_start + run.setup_s) * 1e9
    trees = [t for t in list(rec.roots)
             if t.root.name == "decision" and t.root.start_ns >= t0]
    return sorted(trees, key=lambda t: t.root.start_ns)[:n]


def _per_step_ms(run, ns_of) -> Optional[float]:
    trees = window_decisions(run)
    steps = sum(t.counts().get("drain.steps", 0) for t in trees)
    if not steps:
        return None
    return 1e-6 * sum(ns_of(t) for t in trees) / steps


def dispatch_ms(run) -> Optional[float]:
    """The host's time an iteration outside the condition's reads: the
    ``drain`` spans' self time over ``drain.steps``."""
    return _per_step_ms(run, lambda t: sum(t.self_ns(d)
                                           for d in t.named("drain")))


def wait_ms(run) -> Optional[float]:
    """The host's wait for the card an iteration: the ``drain.read``
    spans over ``drain.steps``."""
    return _per_step_ms(run, lambda t: sum(r.ns
                                           for r in t.named("drain.read")))


def prep_ms(run) -> Optional[float]:
    """A decision's time outside its drain loop: the fan's draw, the
    broadcast of the mirror, metrics, CVaR, selection and the run-mask
    read."""
    trees = window_decisions(run)
    if not trees:
        return None
    return 1e-6 * statistics.fmean(
        t.root.ns - sum(d.ns for d in t.named("drain")) for t in trees)
