"""Deterministic synthetic data pipeline — port of
``repro/data/pipeline.py`` (numpy only, so a seed gives the same
batches in both packages).

``SyntheticLM`` produces language-model batches from a small-order
Markov chain over the vocabulary (uniform tokens would pin the loss at
log V).  ``host_slice`` gives each process its contiguous slice of the
global batch; its index and count come from ``torch.distributed`` when
a process group is initialised, else 0 and 1 (the identity).
``prefetch`` overlaps host-side ingestion with device work: the
block-streamed grids (``core.whatif.sharded_replay_grid``) slice and pad
the next scenario block on its thread while the device replays the
current one.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    branch: int = 32        # out-degree of the markov chain


class SyntheticLM:
    """Markov-chain token stream, deterministic per (seed, step, row)."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # each state has `branch` allowed successors with dirichlet probs
        self._succ = rng.integers(0, v, size=(v, cfg.branch))
        p = rng.dirichlet(np.ones(cfg.branch) * 0.5, size=v)
        self._cum = np.cumsum(p, axis=-1).astype(np.float32)

    def _row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        s = int(rng.integers(0, cfg.vocab_size))
        u = rng.random(cfg.seq_len + 1).astype(np.float32)
        for t in range(cfg.seq_len + 1):
            out[t] = s
            k = int(np.searchsorted(self._cum[s], u[t]))
            s = int(self._succ[s, min(k, cfg.branch - 1)])
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), dtype=np.int32)
        for b in range(cfg.global_batch):
            rng = np.random.default_rng(
                (cfg.seed, step, b))  # content-addressed: restart-safe
            toks[b] = self._row(rng)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((cfg.global_batch, cfg.seq_len), dtype=np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def _process_grid():
    """(index, count) of this process: ``torch.distributed``'s rank and
    world size when a process group is up, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(batch: Dict[str, np.ndarray],
               process_index: Optional[int] = None,
               process_count: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """This process's rows of the global batch (contiguous block split)."""
    pi, pc = _process_grid()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count

    def cut(x: np.ndarray) -> np.ndarray:
        b = x.shape[0]
        if b % pc:
            raise ValueError(f"global batch {b} does not split over "
                             f"{pc} processes")
        per = b // pc
        return x[pi * per:(pi + 1) * per]
    return {k: cut(v) for k, v in batch.items()}


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` on a background thread, at most ``depth`` items ahead
    of the consumer.  A worker's exception is re-raised in the consumer
    after the items produced before it, never swallowed (a failed ingest
    must not look like a shorter stream)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err: list = []

    def worker() -> None:
        try:
            for item in it:
                q.put(item)
        except BaseException as e:           # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item
