"""The yardstick of K1, the scheduling-pass kernel: the least traffic one
launch needs for its inputs, and the card's data-sheet rate.

One pass over k forks of a J-slot job table must, for each fork, scan the
state of every slot (4 B a slot: which jobs are queued, which run), walk
the priority order up to its rank limit and read the node count and
estimate of each queued job it reaches there (12 B a rank), read the
predicted end and node count of each running job (8 B: the reservation),
read its free nodes and clock (8 B) and write its started mask (1 B a
slot) and free nodes (4 B); the launch reads its rank limit once (4 B).
Ranks at or past a fork's queued count hold no queued job, so a fork
walks min(queued, limit) ranks.  The counts are taken from the launch's
own inputs, so the bound is the work these inputs need, whatever
implements the pass, and a kernel that honours the limit is held to it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

#: NVIDIA H100 SXM 80 GB data sheet: HBM3 bytes/s at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(J: int, queued, running, limit: Optional[int] = None) -> int:
    """The least bytes of one launch over forks with ``queued`` and
    ``running`` jobs (one count a fork) under the rank limit (None: J)."""
    q = np.asarray(queued, np.int64)
    r = np.asarray(running, np.int64)
    walk = np.minimum(q, J if limit is None else int(limit))
    per_fork = 5 * J + 12 * walk + 8 * r + 12
    return int(per_fork.sum()) + 4


def k1_bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
