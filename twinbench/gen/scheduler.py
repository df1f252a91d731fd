"""A stand-in for the batch scheduler the twin advises: the events it
publishes, from its own view of the cluster.

At start it submits the backlog (QUEUEJOB at each arrival) and starts
jobs in arrival order while they fit, stopping at the first that does
not (RUNJOB at arrival).  After each decision it starts every job the
twin's ``qrun`` named (RUNJOB at the decision time), then ends the
``obits`` running jobs due first by their predicted end, start +
estimate in float32, ties by job id (JOBOBIT at that end, or at the
scheduler's clock if the end has passed).  Events are plain tuples
``(kind, time, job, payload)``; kinds 0, 1, 2 are QUEUEJOB, RUNJOB,
JOBOBIT.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

QUEUEJOB, RUNJOB, JOBOBIT = 0, 1, 2
EventT = Tuple[int, float, int, Dict[str, float]]


class StandIn:
    def __init__(self, trace: Dict[str, np.ndarray], total_nodes: int,
                 obits: int) -> None:
        self.est = trace["est"].astype(np.float32)
        self.obits = obits
        self.end: Dict[int, np.float32] = {}     # running job -> end
        self.now = np.float32(0.0)
        self.pending: List[EventT] = []
        free = total_nodes
        for j, (t, n, e) in enumerate(zip(trace["submit"].tolist(),
                                          trace["nodes"].tolist(),
                                          trace["est"].tolist())):
            self._emit(QUEUEJOB, t, j, {"nodes": float(n),
                                        "est_runtime": float(e)})
            if n <= free and len(self.end) == j:
                free -= n
                self._start(j, t)

    def _emit(self, kind: int, t: float, job: int, payload=None) -> None:
        self.pending.append((kind, float(t), job, payload or {}))
        self.now = max(self.now, np.float32(t))

    def _start(self, job: int, t: float) -> None:
        self._emit(RUNJOB, t, job)
        self.end[job] = np.float32(t) + self.est[job]

    def qrun(self, jobs: List[int], t: float) -> None:
        for j in jobs:
            self._start(j, t)

    def finish_due(self) -> None:
        """JOBOBIT for the running jobs due first."""
        due = sorted(self.end, key=lambda j: (self.end[j], j))
        for j in due[:self.obits]:
            self._emit(JOBOBIT, float(max(self.end.pop(j), self.now)), j)

    def take(self) -> List[EventT]:
        out, self.pending = self.pending, []
        return out
