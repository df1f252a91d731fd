"""The twin's mirror of the cluster, rebuilt from the published events in
NumPy: one float32/int32 array per job-table field, slot j for job j.

Each job event moves a slot only from the lifecycle state it is valid
from (a duplicate changes nothing): QUEUEJOB places an INVALID slot;
RUNJOB starts a QUEUED job (predicted end = start + estimate, in
float32); JOBOBIT ends a RUNNING job and its nodes come back.  The clock
is the largest applied event time.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from twinbench.reference.sim import DONE, INVALID, QUEUED, RUNNING, TIME_NONE

QUEUEJOB, RUNJOB, JOBOBIT = 0, 1, 2
FIELDS = ("submit", "nodes", "est", "start", "end", "state")


class Mirror:
    def __init__(self, max_jobs: int, total_nodes: int) -> None:
        f32 = lambda: np.full(max_jobs, TIME_NONE, np.float32)  # noqa
        self.submit, self.start, self.end = f32(), f32(), f32()
        self.nodes = np.zeros(max_jobs, np.int32)
        self.est = np.zeros(max_jobs, np.float32)
        self.state = np.zeros(max_jobs, np.int32)
        self.free = np.int32(total_nodes)
        self.total = np.int32(total_nodes)
        self.now = np.float32(0.0)

    def apply(self, kind: int, time: float, job: int,
              payload: Dict[str, float]) -> None:
        t = np.float32(time)
        cur = self.state[job]
        if kind == QUEUEJOB:
            if cur != INVALID:
                return
            self.submit[job] = t
            self.nodes[job] = int(payload["nodes"])
            self.est[job] = np.float32(payload["est_runtime"])
            self.start[job] = self.end[job] = TIME_NONE
            self.state[job] = QUEUED
        elif kind == RUNJOB:
            if cur != QUEUED:
                return
            self.start[job] = t
            self.end[job] = t + self.est[job]
            self.state[job] = RUNNING
            self.free = np.int32(self.free - self.nodes[job])
        elif kind == JOBOBIT:
            if cur != RUNNING:
                return
            self.end[job] = t
            self.state[job] = DONE
            self.free = np.int32(self.free + self.nodes[job])
        else:
            raise ValueError(f"the mirror takes job events, not kind {kind}")
        self.now = max(self.now, t)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {f: getattr(self, f).copy() for f in FIELDS}
        out.update(free=self.free, total=self.total, now=self.now)
        return out
