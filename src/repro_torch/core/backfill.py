"""One scheduling pass: priority order + EASY backfilling.

Port of ``repro/core/backfill.py``.  EASY backfilling (Mu'alem &
Feitelson, ref [18] of the paper):

  1. Walk queued jobs in priority order; start each while it fits.  The
     first job that does not fit becomes the *head* and gets a
     reservation.
  2. The reservation ("shadow") time is the earliest time the head can
     run given the predicted ends of running jobs; ``extra`` is the node
     surplus at that time.
  3. Later queued jobs may backfill now iff they fit now AND either
     (a) end (by estimate) by the shadow time, or (b) use no more than
     ``extra`` nodes.

``schedule_pass_batched`` is the pass over a leading fork axis, in the
call signature of the CUDA kernel it is the plain version of
(``repro_torch.kernels.policy_eval``).  Its semantics are exactly
``schedule_pass_with_order`` of the reference, vmapped: int32 node
arithmetic, the closed-form greedy pass, and the lexicographic
(end, slot) shadow count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import policies
from repro_torch.core.state import QUEUED, RUNNING, SimState

INT32_MAX = 2**31 - 1


class PassResult(NamedTuple):
    state: SimState
    started: torch.Tensor      # bool (..., J) — jobs started in this pass
    head_idx: torch.Tensor     # i32 (...) — reserved job slot (-1 if none)
    shadow_time: torch.Tensor  # f32 (...) — reservation time (+inf if none)


def _keys(state: SimState, policy) -> torch.Tensor:
    if isinstance(policy, policies.PolicySpec):
        return policies.priority_key_spec(state.jobs, state.now, policy)
    return policies.priority_key(state.jobs, state.now, policy)


def _argsort(keys: torch.Tensor) -> torch.Tensor:
    # stable: ties fall back to slot (submission) order, as jnp.argsort
    return torch.argsort(keys, dim=-1, stable=True).to(torch.int32)


def priority_order(state: SimState, policy) -> torch.Tensor:
    """Priority-ranked job slots: queued jobs first by key, every other
    slot last.  ``policy`` is a ``PolicySpec`` (scalar or one row per
    fork of a batched state) or legacy integer id(s)."""
    queued = state.jobs.state == QUEUED
    keys = torch.where(queued, _keys(state, policy), torch.inf)
    return _argsort(keys)


def static_priority_order(state: SimState, policy,
                          ever_queued: torch.Tensor) -> torch.Tensor:
    """Hoisted order for a time-invariant fork: ranked over every slot
    that can ever be queued, computed once per drain."""
    keys = torch.where(ever_queued, _keys(state, policy), torch.inf)
    return _argsort(keys)


def compact_queued_first(order: torch.Tensor,
                         queued: torch.Tensor) -> torch.Tensor:
    """Stable-partition each fork's rank order so QUEUED slots take the
    leading ranks (a cumsum and a row scatter, no sort), which restores
    ``des.pass_rank_limit``'s queued-first contract for hoisted orders."""
    q = torch.gather(queued, 1, order.long())
    nq = torch.cumsum(q, 1, dtype=torch.int32)
    pos = torch.where(q, nq - 1,
                      nq[:, -1:] + torch.cumsum(~q, 1, dtype=torch.int32) - 1)
    return torch.zeros_like(order).scatter(1, pos.long(), order)


def _pass(order: torch.Tensor, state: torch.Tensor, nodes: torch.Tensor,
          est: torch.Tensor, end_t: torch.Tensor, free0: torch.Tensor,
          now: torch.Tensor, limit: Optional[torch.Tensor]):
    """The batched pass: every (k, J) input carries the fork axis;
    ``free0``/``now`` are (k,), ``limit`` an i32 tensor of one element
    (or None for J).  Returns (started, free, head_idx, shadow)."""
    k, J = order.shape
    dev = order.device
    idx = order.long()
    ranks = torch.arange(J, device=dev)
    rank_hi = (torch.full((), J, device=dev) if limit is None
               else limit.reshape(()).long())
    queued = state == QUEUED
    now_col = now[:, None]

    # ---- pass 1: greedy start until the first blocked job (the head) ----
    # A prefix property: with need(r) = cumulative demand of queued ranks
    # <= r, a queued rank starts iff need(r) <= free0.
    q_rank = torch.gather(queued, 1, idx)
    nodes_rank = torch.where(q_rank, torch.gather(nodes, 1, idx), 0)
    need = torch.cumsum(nodes_rank, 1, dtype=torch.int32)
    fits_rank = need <= free0[:, None]
    blocked_rank = q_rank & ~fits_rank
    head_found = blocked_rank.any(1)
    head_rank = torch.argmax(blocked_rank.to(torch.int8), 1)  # first blocked
    started_rank = q_rank & fits_rank
    started = torch.zeros((k, J), dtype=torch.bool, device=dev).scatter(
        1, idx, started_rank)
    free1 = free0 - torch.where(started_rank, nodes_rank, 0).sum(
        1, dtype=torch.int32)
    head_idx = torch.where(head_found,
                           torch.gather(order, 1, head_rank[:, None])[:, 0],
                           -1)

    # ---- shadow time: lexicographic (end, slot) count --------------------
    # cum(i) = free1 + Σ_j nodes_r(j)·[(e_j, j) <= (e_i, i)] over running and
    # just-started jobs; cum rises along that order, so the first feasible
    # item is the lex-min one and both its end and its cum are plain mins.
    running = (state == RUNNING) | started
    end_eff = torch.where(started, now_col + est, end_t)
    end_eff = torch.where(running, end_eff, torch.inf)
    nodes_r = torch.where(running, nodes, 0)
    e_i, e_j = end_eff[:, :, None], end_eff[:, None, :]
    lex_le = (e_j < e_i) | ((e_j == e_i) & (ranks[None, :] <= ranks[:, None]))
    cum_free = free1[:, None] + torch.where(
        lex_le, nodes_r[:, None, :], 0).sum(2, dtype=torch.int32)

    head_nodes = torch.where(
        head_found,
        torch.gather(nodes, 1, head_idx.clamp_min(0).long()[:, None])[:, 0],
        0)
    feasible = (cum_free >= head_nodes[:, None]) & torch.isfinite(end_eff)
    any_feasible = feasible.any(1)
    shadow = torch.where(
        head_found,
        torch.where(feasible, end_eff, torch.inf).amin(1),
        torch.inf)
    cum_first = torch.where(feasible, cum_free, INT32_MAX).amin(1)
    # no head -> unconstrained (vacuous: no queued job remains)
    no_feasible = torch.where(head_found, torch.zeros_like(cum_first),
                              torch.full_like(cum_first, INT32_MAX // 2))
    extra = torch.where(head_found & any_feasible, cum_first - head_nodes,
                        no_feasible)

    # ---- pass 2: EASY backfill over ranks (head, limit) -------------------
    # ``free`` and ``extra`` only fall during the walk, so a rank that does
    # not fit free1, or fails both conditions at extra0, never starts: the
    # walk visits only the other ranks, in order (bit-exact pruning).
    j_nodes = torch.gather(nodes, 1, idx)
    cond_a_rank = (now_col + torch.gather(est, 1, idx)) <= shadow[:, None]
    cand = (head_found[:, None] & (ranks > head_rank[:, None])
            & (ranks < rank_hi) & q_rank & ~started_rank
            & (j_nodes <= free1[:, None])
            & (cond_a_rank | (j_nodes <= extra[:, None])))
    n_cand = int(cand.sum(1).max()) if k else 0
    walk = torch.argsort((~cand).to(torch.int8), dim=1, stable=True)
    free = free1.clone()
    extra = extra.clone()
    rows = torch.arange(k, device=dev)
    for c in range(n_cand):
        r = walk[:, c]
        live = cand[rows, r]
        nd = j_nodes[rows, r]
        cond_a = cond_a_rank[rows, r]
        start = live & (nd <= free) & (cond_a | (nd <= extra))
        free = torch.where(start, free - nd, free)
        extra = torch.where(start & ~cond_a, extra - nd, extra)
        started[rows[start], idx[rows, r][start]] = True
    return started, free, head_idx.to(torch.int32), shadow


def schedule_pass_batched(order: torch.Tensor, state: torch.Tensor,
                          nodes: torch.Tensor, est: torch.Tensor,
                          end_t: torch.Tensor, free0: torch.Tensor,
                          now: torch.Tensor,
                          limit: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the K1 kernel: (started (k, J) bool, free (k,)
    i32).  Inputs as ``kernels.policy_eval.policy_eval_pass_batched``."""
    started, free, _, _ = _pass(order, state, nodes, est, end_t, free0,
                                now, limit)
    return started, free


def schedule_pass_with_order(state: SimState, order: torch.Tensor,
                             limit=None) -> PassResult:
    """The pass proper for one fork (unbatched ``state``, (J,) order) or
    a batch (leading fork axis on every leaf).  ``limit`` bounds both
    rank walks; ranks at or past it must hold no queued slot."""
    batched = order.ndim == 2
    lift = (lambda x: x) if batched else (lambda x: x[None])
    jobs = state.jobs
    if limit is not None:
        limit = torch.as_tensor(limit, dtype=torch.int32,
                                device=order.device).reshape(1)
    started, free, head_idx, shadow = _pass(
        lift(order), lift(jobs.state), lift(jobs.nodes),
        lift(jobs.est_runtime), lift(jobs.end_t), lift(state.free_nodes),
        lift(state.now), limit)
    if not batched:
        started, free, head_idx, shadow = (
            started[0], free[0], head_idx[0], shadow[0])
    now = state.now[..., None]
    new_jobs = jobs._replace(
        start_t=torch.where(started, now, jobs.start_t),
        end_t=torch.where(started, now + jobs.est_runtime, jobs.end_t),
        state=torch.where(started, RUNNING, jobs.state),
    )
    return PassResult(state=state._replace(jobs=new_jobs, free_nodes=free),
                      started=started, head_idx=head_idx,
                      shadow_time=shadow)


def schedule_pass(state: SimState, policy) -> PassResult:
    """Keys + argsort + the order-driven pass (scalar convenience)."""
    return schedule_pass_with_order(state, priority_order(state, policy))
