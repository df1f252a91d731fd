"""Serving substrate: prefill / decode entry points + a continuous-
batching engine with pluggable admission.

Port of ``repro/serve/engine.py`` for one GPU (no cache shardings, no
jitted decode: PyTorch runs eagerly).  ``ServingEngine`` keeps the
reference's slots, admission hook, clock (one tick per decode step) and
first/finish times, so that both packages give the same token streams on
the same weights.  It runs under ``torch.inference_mode()``, with the
caches preallocated on the device and written in place.

Like the reference, every decode step runs all slots at one index, the
largest position among them (ROADMAP C6): a slot with a shorter prompt
writes past its own length and attends over zero-filled cache rows.
The port reproduces this so that token streams match.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.lm import LM, Caches


def make_serve_fns(cfg: ModelConfig, backend: str = "cuda"):
    """Returns (prefill_fn, decode_fn).  ``decode_fn`` returns the next
    token of every row (greedy, the first index of the largest logit, as
    ``jnp.argmax``), the top-1 minus top-2 logit gap of each row, and
    the caches."""

    def prefill_fn(model: LM, batch: Dict[str, torch.Tensor]):
        return api.prefill(cfg, model, batch, backend)

    def decode_fn(model: LM, caches: Caches, tokens: torch.Tensor,
                  index: int):
        logits, caches = api.decode_step(
            cfg, model, caches, {"tokens": tokens, "index": index}, backend)
        next_tok, gap = greedy(logits[:, -1, :])
        return next_tok, gap, caches

    return prefill_fn, decode_fn


def greedy(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, V) logits -> (argmax (B,) int32, top-1 minus top-2 gap (B,))."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            top2[:, 0] - top2[:, 1])


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # (S_prompt,) int32
    max_new_tokens: int
    arrival_t: float = 0.0
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    #: top-1 minus top-2 logit of the step that chose each output token
    #: (how close a greedy pick was to a tie; not in the reference)
    margins: List[float] = dataclasses.field(default_factory=list)


class ServingEngine:
    """Slot-based continuous batching over a single decode batch.

    The engine keeps ``batch_slots`` sequences in flight.  Each loop
    iteration decodes one token for every slot; finished slots are
    refilled via ``admission`` (FIFO by default; the index into the
    queue of the request to admit).  Prefill for an admitted request
    runs per slot, batch 1, and its cache is copied into the slot.
    ``model`` must live on ``device``.
    """

    def __init__(self, cfg: ModelConfig, model: LM, batch_slots: int,
                 max_seq: int,
                 admission: Optional[Callable[[List[Request]], int]] = None,
                 *, device: DeviceLike = "cuda",
                 backend: str = "cuda") -> None:
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = batch_slots
        self.max_seq = max_seq
        self.admission = admission
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.clock = 0.0

        self._prefill, self._decode = make_serve_fns(cfg, backend)
        self.caches = api.init_caches(cfg, batch_slots, max_seq,
                                      device=model.device)
        self._tokens = np.zeros((batch_slots, 1), dtype=np.int32)
        self._pos = np.zeros((batch_slots,), dtype=np.int64)

    # -- admission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrival_t = self.clock
        self.queue.append(req)

    def _admit_next(self) -> Optional[Request]:
        if not self.queue:
            return None
        idx = self.admission(self.queue) if self.admission else 0
        return self.queue.pop(idx)

    def _fill_slot(self, slot: int, req: Request) -> None:
        prompt = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64)[None],
                                 device=self.model.device)
        logits, caches1 = self._prefill(self.model, {"tokens": prompt})
        tok, gap = greedy(logits[:, -1])
        _write_caches(self.caches, caches1, slot)
        tok, gap = int(tok[0]), float(gap[0])
        req.output.append(tok)
        req.margins.append(gap)
        req.first_token_t = self.clock
        self._tokens[slot, 0] = tok
        self._pos[slot] = len(req.prompt)
        self.active[slot] = req

    # -- main loop ------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration; returns #active slots."""
        for s in range(self.slots):
            if self.active[s] is None:
                req = self._admit_next()
                if req is not None:
                    self._fill_slot(s, req)
        if all(a is None for a in self.active):
            return 0

        index = int(self._pos.max())
        toks = torch.as_tensor(self._tokens.astype(np.int64),
                               device=self.model.device)
        next_tok, gap, self.caches = self._decode(self.model, self.caches,
                                                  toks, index)
        picked = torch.stack([next_tok.float(), gap]).cpu().numpy()
        self.clock += 1.0
        n_active = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(picked[0, s])
            req.output.append(tok)
            req.margins.append(float(picked[1, s]))
            self._tokens[s, 0] = tok
            self._pos[s] += 1
            if (len(req.output) >= req.max_new_tokens
                    or self._pos[s] >= self.max_seq - 1):
                req.done = True
                req.finish_t = self.clock
                self.active[s] = None
            else:
                n_active += 1
        return n_active + sum(r is not None for r in self.active)

    def run_until_drained(self, max_iters: int = 100_000) -> None:
        for _ in range(max_iters):
            if self.step() == 0 and not self.queue:
                return
        raise RuntimeError("serving engine did not drain")


def _write_caches(big: Caches, small: Caches, slot: int) -> None:
    """``_write_slot`` on every leaf of the batched caches, which nest
    (a pattern layer holds one sub-cache per block), from the batch-1
    caches of one prefill."""
    for name, leaf in big.items():
        if isinstance(leaf, dict):
            _write_caches(leaf, small[name], slot)
        else:
            _write_slot(leaf, small[name], slot)


def _write_slot(big: torch.Tensor, small: torch.Tensor, slot: int) -> None:
    """Write a batch-1 cache leaf into slot ``slot`` of the batched cache,
    in place, by the reference's rule: the batch axis is the first axis
    where ``small`` has 1 and ``big`` differs; the other axes of
    ``small`` are zero-padded up to ``big``'s (the slot's old contents
    past the new prompt are cleared); the slot start is clamped into
    range.  Where no such axis exists the reference keeps ``big``
    unchanged (with one slot and a prompt longer than one token, a
    dense cache is not written), and so does this.  Equal shapes
    replace ``big``'s contents."""
    if big.ndim == 0 or big.shape == small.shape:
        big.copy_(small)
        return
    for batch_ax in range(small.ndim):
        if small.shape[batch_ax] == 1 and big.shape[batch_ax] != 1:
            break
    else:
        return
    if any(s > b for s, b in zip(small.shape, big.shape)):
        raise ValueError(f"cache leaf {tuple(small.shape)} does not fit "
                         f"the slot cache {tuple(big.shape)}")
    start = min(slot, big.shape[batch_ax] - 1)
    region = big.narrow(batch_ax, start, 1)
    region.zero_()
    region[tuple(slice(0, n) for n in small.shape)] = small.to(big.dtype)
