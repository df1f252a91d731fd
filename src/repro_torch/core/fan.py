"""On-device Monte-Carlo scenario fans (DESIGN.md §10) — port of
``repro/core/fan.py``.

A fan evaluates F *perturbed* futures per (scenario, policy) cell instead
of one, and selects by a distributional goal (``objective.Distributional``:
``p95:avg_wait``, ``cvar:0.9:...``, ``worst:``, ``regret:``).

The base ``ScenarioSet`` goes to the device once ((S, J) tensors) and the
F perturbations are derived there from per-member keys: no host copies of
the F traces.  Member φ of scenario s rides the fork axis as
pseudo-scenario ``g = s·F + φ`` (flat fork ``f = g·P + p``), which keeps
the hoist plans P-periodic.

Three perturbation models, each gated in Python on its ``FanSpec`` field
(a zeroed model is not run, so the degenerate spec is bitwise
``engine.replay_grid``), all keyed per (s, φ) independently of F through
``prng.fold_in`` chains — the reference's threefry draws, bit for bit —
so fans are deterministic and **prefix-stable** (the members of a low-F
pre-pass are the first members of the full fan):

* ``runtime_noise`` — mean-preserving lognormal noise on TRUE runtimes
  (``exp(σ·ε − σ²/2)``); estimates stay untouched;
* ``burst_amplitude``/``burst_period`` — a monotone sinusoidal warp of
  the arrival timeline with a per-member random phase;
* ``failure_prob``/``failure_frac`` — per-member node-failure draws
  (i.i.d., or with ``failure_domains = D > 0`` the correlated
  rack/power-domain model: latent fragilities ``q[s, d]`` keyed on
  ``(seed, s, d)`` only, one uniform per member thresholded against
  ``min(2·failure_prob·q, 1)``, so failure sets nest across members).

Member φ=0 is always exact (selected with ``torch.where``, never by
arithmetic): an F=1 fan is bitwise the plain replay for any spec.

``pruned_fan_grid`` runs a cheap low-F pre-pass, drops the policies an
index-guarded first-order dominance bound proves the goal never selects,
and replays only the remaining member suffix over the kept sub-pool.

The f32 arithmetic follows the reference's: ``exp`` is ``prng.exp_f32``
and the burst warp's ``sin`` is ``prng.sin_f32`` (XLA's, bitwise), and
the multiply-adds XLA fuses are fused here too.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

__all__ = [
    "FanSpec", "PruneInfo", "perturb_block", "perturb_rows",
    "perturb_window", "materialize_fan", "dominance_keep",
    "pruned_fan_grid", "normalize_fan", "fit_runtime_sigma",
    "failure_downs", "lognormal_scale",
]


@dataclasses.dataclass(frozen=True)
class FanSpec:
    """How to grow F perturbed futures from one base scenario.

    Frozen and hashable.  All randomness derives from ``seed`` through
    per-(scenario, member) ``fold_in`` chains: the same member gets the
    same perturbation whatever F or the batching.
    """

    n: int = 1                    # fan size F (members per scenario)
    runtime_noise: float = 0.0    # σ of lognormal true-runtime noise
    burst_amplitude: float = 0.0  # arrival warp amplitude A in [0, 1)
    burst_period: float = 3600.0  # arrival warp period (seconds)
    failure_prob: float = 0.0     # P(member loses nodes) in [0, 1]
    failure_frac: float = 0.25    # max fraction of nodes lost
    failure_domains: int = 0      # D rack/power domains (0 = i.i.d.)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"fan size must be >= 1, got {self.n}")
        if not 0.0 <= self.burst_amplitude < 1.0:
            raise ValueError(
                f"burst_amplitude must be in [0, 1) to keep the arrival "
                f"warp monotone, got {self.burst_amplitude}")
        if self.burst_period <= 0.0:
            raise ValueError("burst_period must be positive")
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob must be in [0, 1]")
        if not 0.0 <= self.failure_frac <= 1.0:
            raise ValueError("failure_frac must be in [0, 1]")
        if self.failure_domains < 0:
            raise ValueError("failure_domains must be >= 0")
        if self.runtime_noise < 0.0:
            raise ValueError("runtime_noise must be >= 0")

    @property
    def degenerate(self) -> bool:
        """True when every perturbation model is off: the fan is exactly
        the base expansion (bitwise ``replay_grid``)."""
        return (self.runtime_noise == 0.0 and self.burst_amplitude == 0.0
                and self.failure_prob == 0.0)

    @classmethod
    def from_history(cls, telemetry, n: int = 64, *,
                     min_samples: int = 8, fallback: float = 0.3,
                     **kwargs) -> "FanSpec":
        """Fit ``runtime_noise`` to the twin's own observed
        estimate-vs-true residuals (``Telemetry.runtime_residuals``, or
        any iterable of ``(estimated, actual)`` pairs): the MLE of the
        lognormal model is the sample std of ``log(actual/est)``;
        ``fallback`` until ``min_samples`` pairs are seen."""
        res = getattr(telemetry, "runtime_residuals", telemetry)
        sigma = fit_runtime_sigma(res, min_samples=min_samples,
                                  fallback=fallback)
        return cls(n=n, runtime_noise=sigma, **kwargs)


def normalize_fan(fan) -> FanSpec:
    """A ``FanSpec``, or a bare int F (a degenerate F-member fan)."""
    if isinstance(fan, FanSpec):
        return fan
    return FanSpec(n=int(fan))


def fit_runtime_sigma(residuals, *, min_samples: int = 8,
                      fallback: float = 0.3) -> float:
    """σ̂ = sample std (ddof=1) of ``log(actual/est)`` over the finite
    positive ``(est, actual)`` pairs; ``fallback`` below ``min_samples``
    usable pairs.  Host arithmetic."""
    logs = []
    for est, actual in residuals:
        e, a = float(est), float(actual)
        if e > 0.0 and a > 0.0 and np.isfinite(e) and np.isfinite(a):
            logs.append(np.log(a / e))
    if len(logs) < max(min_samples, 2):
        return float(fallback)
    return float(np.std(np.asarray(logs), ddof=1))


def lognormal_scale(z: torch.Tensor, sigma: float) -> torch.Tensor:
    """The mean-preserving factor ``exp(σ·ε − σ²/2)`` of standard normals
    ``ε = √2·z`` (``z = erf_inv(u)``, as ``_member_draws`` returns them),
    in the reference's compiled f32 arithmetic: XLA folds ``σ·√2`` into
    one f32 constant and fuses the multiply-add; ``exp`` is XLA's."""
    k = float(np.float32(prng.SQRT2_F32) * np.float32(sigma))
    return prng.exp_f32(prng._fma(z, k, -(0.5 * sigma * sigma)))


# ----------------------------------------------------------------------
# Per-member draws.  Key chain: seed -> scenario s -> member φ -> tag.
# φ-keyed, not F-keyed: prefixes are stable.
# ----------------------------------------------------------------------

def _scenario_keys(seed: int, s: torch.Tensor) -> torch.Tensor:
    return prng.fold_in(prng.PRNGKey(seed, device=s.device), s)


def _member_draws(seed: int, s: torch.Tensor, phi: torch.Tensor, J: int):
    """Perturbation draws for (B,) (scenario, member) pairs: the
    runtime-noise normals over √2 (B, J) — ``erf_inv`` of the reference's
    uniforms; ``lognormal_scale`` applies the √2 — a burst phase (B,) and
    two uniforms (B, 2) (failure hit and severity)."""
    k = prng.fold_in(_scenario_keys(seed, s), phi)
    eps = prng.normal_over_sqrt2(prng.fold_in(k, 0), (J,))
    phase = prng.uniform(prng.fold_in(k, 1), (), 0.0, 2.0 * np.pi)
    u = prng.uniform(prng.fold_in(k, 2), (2,))
    return eps, phase, u


#: Domain-fragility key tag, folded where the member φ normally goes: the
#: chain stays (seed → s → ·) and never collides with a real member.
_DOMAIN_TAG = 0x7FFFFFFF


def _domain_fragility(seed: int, s: torch.Tensor, D: int) -> torch.Tensor:
    """Latent fragilities (B, D) in [0, 1) of the D domains of each
    scenario in ``s``, keyed on (seed, s, d) only: every member, racing
    window and repeated decision sees the same weak domains."""
    k = prng.fold_in(_scenario_keys(seed, s), _DOMAIN_TAG)
    return prng.uniform(k, (D,))


def failure_downs(spec: FanSpec, s: torch.Tensor, phi: torch.Tensor,
                  u: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """Per-row node-capacity reductions of the failure model, shared by
    ``perturb_rows`` and the drain-side fans.  ``u`` is the (B, 2) member
    uniform pair, ``s``/``phi`` the (B,) ids, ``tot`` the (B,) capacities;
    exact members (φ=0) always get 0.  ``failure_domains == 0`` is the
    i.i.d. draw; ``D > 0`` the domain model (module docstring), losing
    ``floor(tot · n_failed / D)`` nodes capped at
    ``floor(tot · failure_frac)``."""
    exact = phi == 0
    totf = tot.to(torch.float32)
    if spec.failure_domains > 0:
        D = spec.failure_domains
        q = _domain_fragility(spec.seed, s, D)                # (B, D)
        thresh = torch.clamp(2.0 * spec.failure_prob * q, max=1.0)
        hit_d = (u[:, :1] < thresh) & (~exact)[:, None]
        n_fail = hit_d.sum(1).to(torch.float32)
        down = torch.floor(totf * (n_fail / D))
        down = torch.minimum(down, torch.floor(totf * spec.failure_frac))
    else:
        hit = (u[:, 0] < spec.failure_prob) & ~exact
        frac = u[:, 1] * spec.failure_frac
        down = torch.where(hit, torch.floor(totf * frac),
                           torch.zeros_like(totf))
    return down.to(tot.dtype)


def perturb_rows(submit, nodes, est, true_rt, valid, totals,
                 spec: FanSpec, s: torch.Tensor, phi: torch.Tensor,
                 inert: torch.Tensor):
    """Perturb explicit (scenario, member) rows — the shared core of
    ``perturb_block`` (contiguous fans) and ``perturb_window`` (member
    windows).  The perturbations depend only on (spec.seed, s, φ), never
    on the batching, so a row built here is bitwise the same row of the
    full fan."""
    sub, nod, es, tr = submit[s], nodes[s], est[s], true_rt[s]
    val, tot = valid[s], totals[s]

    if not spec.degenerate:
        J = submit.shape[1]
        eps, phase, u = _member_draws(spec.seed, s, phi, J)
        exact = phi == 0
        if spec.runtime_noise > 0.0:
            scale = lognormal_scale(eps, spec.runtime_noise)
            tr = torch.where(exact[:, None], tr, tr * scale)
        if spec.burst_amplitude > 0.0:
            omega = 2.0 * np.pi / spec.burst_period
            amp = spec.burst_amplitude / omega
            arg = prng._fma(sub, omega, phase[:, None])
            warped = prng._fma(prng.sin_f32(arg) - prng.sin_f32(phase)[:, None],
                               amp, sub)
            # monotone in exact arithmetic (derivative >= 1 - A > 0);
            # cummax irons out any f32 rounding inversion so the arrival
            # cursor stays valid
            warped = torch.cummax(warped, 1).values
            sub = torch.where(exact[:, None], sub, warped)
        if spec.failure_prob > 0.0:
            down = failure_downs(spec, s, phi, u, tot)
            tot = torch.clamp(tot - down, min=1)

    val = val & ~inert[:, None]
    tot = torch.where(inert, torch.ones_like(tot), tot)
    return sub, nod, es, tr, val, tot


def perturb_block(submit, nodes, est, true_rt, valid, totals,
                  spec: FanSpec, g: torch.Tensor, S: int):
    """Expand base (S, J) scenario tensors into pseudo-scenarios
    ``g = s·F + φ``; ids past ``S·F`` become inert rows (valid all-False,
    ``total_nodes=1``)."""
    F = spec.n
    inert = g >= S * F
    gc = torch.clamp(g, max=S * F - 1)
    return perturb_rows(submit, nodes, est, true_rt, valid, totals,
                        spec, gc // F, gc % F, inert)


def perturb_window(submit, nodes, est, true_rt, valid, totals,
                   spec: FanSpec, r: torch.Tensor, lo: int, width: int,
                   S: int):
    """Expand only members ``φ ∈ [lo, lo+width)`` of each scenario: row
    ``r = s·width + w`` is member ``lo + w`` of scenario s, bitwise row
    ``s·F + φ`` of the full fan."""
    inert = r >= S * width
    rc = torch.clamp(r, max=S * width - 1)
    return perturb_rows(submit, nodes, est, true_rt, valid, totals,
                        spec, rc // width, lo + rc % width, inert)


# ----------------------------------------------------------------------
# Host materialization: the bitwise oracle, never on the main path.
# ----------------------------------------------------------------------

def materialize_fan(scenarios, spec: FanSpec, device="cuda"):
    """The fan as a plain host ``ScenarioSet`` of S·F pseudo-scenarios
    (row ``s·F + φ`` = member φ of scenario s) with the same
    perturbations, derived on ``device`` and copied back:
    ``replay_grid(materialize_fan(sc, spec), pool)`` is bitwise
    ``fan_grid(sc, pool, spec)``."""
    from repro_torch.core.engine import _scenario_arrays
    dev = resolve_device(device)
    S = int(scenarios.total_nodes.shape[0])
    g = torch.arange(S * spec.n, device=dev)
    rows = perturb_block(*_scenario_arrays(scenarios, dev), spec, g, S)
    sub, nod, es, tr, val, tot = (x.cpu().numpy() for x in rows)
    return dataclasses.replace(
        scenarios, submit_t=sub, nodes=nod, est_runtime=es,
        true_runtime=tr, valid=val,
        n_jobs=np.repeat(np.asarray(scenarios.n_jobs), spec.n),
        total_nodes=tot)


# ----------------------------------------------------------------------
# Goal-conditioned pool pruning.
# ----------------------------------------------------------------------

class PruneInfo(NamedTuple):
    """What the pre-pass dropped and how the sub-grid maps back."""
    keep: np.ndarray        # kept FULL-pool indices, ascending
    best: np.ndarray        # (S,) winners as FULL-pool indices
    rate: float             # fraction of the pool pruned
    pre_members: np.ndarray  # (S, pre_n, P) pre-pass member costs
    members: int = 0        # (s, φ, p) triples actually replayed
    members_full: int = 0   # triples an unpruned full fan replays


def dominance_keep(member_costs: np.ndarray,
                   pointwise: bool = False) -> np.ndarray:
    """(P,) keep mask from (S, F0, P) member costs: policy p is dropped
    iff in every scenario some policy q < p is no worse on every member —
    sorted members (first-order dominance) for the symmetric monotone
    reductions, raw CRN-aligned members for ``regret:``
    (``pointwise=True``).  NaNs never dominate."""
    c = np.asarray(member_costs, dtype=np.float64)
    if c.ndim != 3:
        raise ValueError(f"member costs must be (S, F, P), got {c.shape}")
    if not pointwise:
        c = np.sort(c, axis=1)
    le = (c[:, :, :, None] <= c[:, :, None, :]).all(axis=1)
    P = c.shape[-1]
    earlier = np.arange(P)[:, None] < np.arange(P)[None, :]   # q < p
    dominated = (le & earlier).any(axis=1)                    # (S, P)
    return ~dominated.all(axis=0)


def pruned_fan_grid(scenarios, pool, fan, objective=None, *,
                    engine=None, pre_n: int = 16):
    """Two-pass fan evaluation: a ``pre_n``-member pre-pass, the
    dominance prune, then only the member suffix ``φ ∈ [pre_n, F)`` over
    the kept sub-pool, concatenated with the donated pre-pass members
    (prefix stability makes them the full fan's first members, so no
    triple is replayed twice).

    Returns ``(outcome, info)``: ``outcome`` is the full-F
    ``engine.FanOutcome`` over the kept pool (``result`` None — it is
    assembled from pieces); ``info.best`` maps each scenario's winner
    back to a full-pool index."""
    from repro_torch.core import engine as _eng
    from repro_torch.core.objective import as_distributional, resolve_goal
    eng = engine if engine is not None else _eng.DrainEngine()
    spec = normalize_fan(fan)
    goal = resolve_goal(objective)
    pool = _eng.as_pool(pool)
    pre = dataclasses.replace(spec, n=min(pre_n, spec.n))
    pre_out = eng.fan_grid(scenarios, pool, pre, goal)
    pre_members = pre_out.member_costs.cpu().numpy()
    pointwise = as_distributional(goal).reduction == "regret"
    keep = dominance_keep(pre_members, pointwise=pointwise)
    keep_idx = np.nonzero(keep)[0]
    P = keep.shape[0]
    Pk = len(keep_idx)
    S = int(scenarios.total_nodes.shape[0])
    kp = torch.as_tensor(keep_idx, device=eng.device)
    sub_pool = (pool if Pk == P else _eng._index_pool(
        _eng._pool_to(pool, eng.device), kp))
    take = lambda x: x[:, :, kp]                          # noqa: E731
    if pre.n == spec.n:
        metrics_k = _eng.DrainMetrics(*(take(m) for m in pre_out.metrics))
        dead_k, start_k, end_k, events_k = (
            take(x) for x in (pre_out.deadlocked, pre_out.start_t,
                              pre_out.end_t, pre_out.events))
    else:
        suf = eng.fan_window_grid(scenarios, sub_pool, spec, goal,
                                  lo=pre.n, width=spec.n - pre.n)
        cat = lambda a, b: torch.cat([take(a), b], 1)     # noqa: E731
        metrics_k = _eng.DrainMetrics(*(
            cat(a, b) for a, b in zip(pre_out.metrics, suf.metrics)))
        dead_k = cat(pre_out.deadlocked, suf.deadlocked)
        start_k = cat(pre_out.start_t, suf.start_t)
        end_k = cat(pre_out.end_t, suf.end_t)
        events_k = cat(pre_out.events, suf.events)
    flat = _eng.DrainMetrics(*(m.reshape(S * spec.n * Pk)
                               for m in metrics_k))
    member, costs, best, ci, width = _eng.fan_select(
        goal, flat, dead_k.reshape(-1), spec.n, Pk)
    out = _eng.FanOutcome(
        start_t=start_k, end_t=end_k, metrics=metrics_k,
        deadlocked=dead_k, events=events_k, result=None,
        member_costs=member, costs=costs, best=best,
        cost_ci=ci, fan_width=width)
    info = PruneInfo(
        keep=keep_idx,
        best=keep_idx[best.cpu().numpy()],
        rate=1.0 - Pk / P,
        pre_members=pre_members,
        members=S * (pre.n * P + (spec.n - pre.n) * Pk),
        members_full=S * spec.n * P,
    )
    return out, info
