"""First-class optimization goals (§3.4's "administrator configured
optimization goal") — port of ``repro/core/objective.py`` (DESIGN.md §8).

Every ``Objective`` maps ``DrainMetrics`` (candidates on the last axis)
to ``(..., k)`` costs, smaller is better; selection is an argmin that
keeps the first index.  Objectives are frozen dataclasses, hashable,
and share the reference's grammar (``parse_objective``):

    "score"                          the paper's 4-term score (default)
    "avg_wait"                       one metric (utilization is a reward:
                                     its cost is negated)
    "0.5*avg_wait+0.5*max_slowdown"  weighted combination (raw units)
    "lex:avg_wait,makespan"          lexicographic
    "min:avg_wait@util>=0.85"        constrained, with a least-violation
                                     fallback when no fork is feasible
    "p95:avg_wait", "cvar:0.9:..."   distributional (fan goals; without a
    "worst:", "regret:", "mean:"     fan axis they reduce to the inner goal)

Rank-based goals (``lex:``/``min:...@``) compose dense ranks
``r[i] = #{j : v[j] < v[i]}`` into one cost ``Σ r_l · (k+1)^(L-1-l)``,
exact in f32 while ``(k+1)^L < 2^24``.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import (Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.des import DrainMetrics, cvar_tail_count, quantile_index
from repro_torch.core.scoring import PAPER_WEIGHTS, ScoreWeights

__all__ = [
    "Objective", "PaperScore", "Weighted", "Lexicographic", "Constraint",
    "Constrained", "Distributional", "ObjectiveLike", "DEFAULT_OBJECTIVE",
    "METRICS", "REWARD_METRICS", "parse_objective", "validate_objective",
    "normalize_objective", "resolve_goal", "as_distributional",
    "register_objective", "registered_objectives", "metric_cost",
    "metrics_from_rows", "report_costs",
]

#: Metric fields an objective may reference — the ``DrainMetrics``
#: fields produced by ``des.drain_metrics`` / ``des.state_metrics``.
METRICS: Tuple[str, ...] = DrainMetrics._fields

#: Metrics that are *rewards* (higher = better): their cost is negated
#: so every objective stays a minimization.
REWARD_METRICS = frozenset({"utilization"})

_ALIASES = {"util": "utilization"}

_WT_SCALE = scoring._WT_SCALE  # seconds -> minutes, the paper score's scale


def _metric(name: str) -> str:
    name = name.strip().lower()
    name = _ALIASES.get(name, name)
    if name not in METRICS:
        raise ValueError(
            f"unknown metric {name!r}; objectives index {METRICS} "
            f"(aliases: {sorted(_ALIASES)})")
    return name


def metric_cost(metrics: DrainMetrics, name: str) -> torch.Tensor:
    """One metric as a cost (rewards negated), broadcasting over any
    leading candidate axes."""
    v = getattr(metrics, name)
    return -v if name in REWARD_METRICS else v


def _fmt(v: float) -> str:
    """Full-precision float formatting for canonical specs: ``repr``
    is the shortest string that round-trips through ``float`` exactly,
    so ``parse_objective(obj.spec) == obj`` holds for ANY coefficient
    (``%g`` truncated to 6 significant digits and broke round-trip)."""
    return repr(float(v))


# ----------------------------------------------------------------------
# Dense-rank composition (lex / constrained goals).
# ----------------------------------------------------------------------

def _dense_rank(v: torch.Tensor) -> torch.Tensor:
    """(..., k) -> (..., k) dense ranks along the candidate axis:
    ``r[i] = #{j : v[j] < v[i]}``.  Equal values share a rank, so exact
    float ties stay ties (the argmin's first-occurrence tie-break —
    pool position — then decides, as everywhere else)."""
    lt = v[..., None, :] < v[..., :, None]            # [..., i, j]
    return lt.sum(-1).to(torch.float32)


def _rank_compose(levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Lexicographic composition of cost levels into ONE (..., k) cost:
    ``Σ rank_l · (k+1)^(L-1-l)``.  Exact in f32 while
    ``(k+1)^L < 2^24``."""
    k = levels[0].shape[-1]
    cost = torch.zeros_like(levels[0], dtype=torch.float32)
    for v in levels:
        cost = cost * (k + 1) + _dense_rank(v)
    return cost


# ----------------------------------------------------------------------
# The Objective hierarchy.
# ----------------------------------------------------------------------

class Objective:
    """A first-class optimization goal.

    Subclasses are frozen dataclasses (hashable)
    implementing:

    * ``costs(metrics)``      — pure tensor ``(..., k)`` costs
      over the candidate axis (last axis of the metric fields);
      smaller is better, ties break by pool position downstream;
    * ``cost_terms(metrics)`` — the per-term breakdown as a dict of
      ``(..., k)`` arrays (telemetry: every fork's cost decomposition,
      not just the winner's);
    * ``spec``                — the canonical grammar string;
      ``parse_objective(obj.spec) == obj`` round-trips.
    """

    #: Whether ``costs`` is a per-candidate scalar in metric units
    #: (True: score/weighted goals) or a composed RANK over the
    #: candidate field (False: lex/constrained) — rank costs only
    #: order candidates and are meaningless for a single candidate.
    elementwise: bool = True

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        raise NotImplementedError

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @property
    def spec(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.spec


@dataclasses.dataclass(frozen=True)
class PaperScore(Objective):
    """The paper's §3.4 score — the bit-exact default goal.

    ``costs`` IS ``scoring.policy_cost`` (same arithmetic, same wait
    minute-scale), so ``objective="score"`` decisions are bit-identical
    to the pre-objective ``ScoreWeights`` path, and a legacy
    ``weights=ScoreWeights(...)`` kwarg lifts here losslessly.
    """
    weights: ScoreWeights = PAPER_WEIGHTS

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        return scoring.policy_cost(metrics, self.weights)

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        w = self.weights
        return {
            "max_wait": w.max_wait * metrics.max_wait * _WT_SCALE,
            "max_slowdown": w.max_slowdown * metrics.max_slowdown,
            "avg_wait": w.avg_wait * metrics.avg_wait * _WT_SCALE,
            "avg_slowdown": w.avg_slowdown * metrics.avg_slowdown,
        }

    @property
    def spec(self) -> str:
        if self.weights == PAPER_WEIGHTS:
            return "score"
        return "score:" + ":".join(
            f"{f}={_fmt(v)}" for f, v in zip(ScoreWeights._fields,
                                             self.weights))


@dataclasses.dataclass(frozen=True)
class Weighted(Objective):
    """``Σ coeff · metric_cost`` in raw metric units (waits in seconds
    — unlike the paper score's minute scale; pick coefficients
    accordingly).  A single ``(1, metric)`` term is the single-metric
    goal the grammar spells as the bare metric name."""
    terms: Tuple[Tuple[float, str], ...]

    def __post_init__(self) -> None:
        if not self.terms:
            raise ValueError("Weighted objective needs at least one term")
        for _, m in self.terms:
            if m not in METRICS:
                raise ValueError(f"unknown metric {m!r}; have {METRICS}")

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        total = None
        for c, m in self.terms:
            t = c * metric_cost(metrics, m)
            total = t if total is None else total + t
        return total

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for i, (c, m) in enumerate(self.terms):
            key = m if c == 1.0 else f"{c:g}*{m}"
            if key in out:                      # duplicate metric terms
                key = f"{key}#{i}"
            out[key] = c * metric_cost(metrics, m)
        return out

    @property
    def spec(self) -> str:
        return "+".join(m if c == 1.0 else f"{_fmt(c)}*{m}"
                        for c, m in self.terms)


@dataclasses.dataclass(frozen=True)
class Lexicographic(Objective):
    """Minimize ``levels[0]``; break exact cost ties by ``levels[1]``;
    and so on.  Compiled via dense-rank composition (module docstring),
    so the result is still one ``(..., k)`` cost vector — the reported
    costs are composed *ranks* (a total order), while ``cost_terms``
    carries each level's raw values."""
    levels: Tuple[Objective, ...]
    elementwise = False

    def __post_init__(self) -> None:
        if len(self.levels) < 2:
            raise ValueError("lex: needs at least two levels")

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        return _rank_compose([lv.costs(metrics) for lv in self.levels])

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        return {f"lex{i}:{lv.spec}": lv.costs(metrics)
                for i, lv in enumerate(self.levels)}

    @property
    def spec(self) -> str:
        return "lex:" + ",".join(lv.spec for lv in self.levels)


_CONSTRAINT_OPS = (">=", "<=")


@dataclasses.dataclass(frozen=True)
class Constraint:
    """``metric >= bound`` or ``metric <= bound`` on a raw metric value
    (NOT the negated cost: ``util>=0.85`` means utilization >= 0.85)."""
    metric: str
    op: str
    bound: float

    def __post_init__(self) -> None:
        if self.metric not in METRICS:
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.op not in _CONSTRAINT_OPS:
            raise ValueError(
                f"constraint op must be one of {_CONSTRAINT_OPS}, "
                f"got {self.op!r}")

    def violation(self, metrics: DrainMetrics) -> torch.Tensor:
        """How far outside the feasible region (>= 0; 0 = satisfied)."""
        v = getattr(metrics, self.metric)
        gap = self.bound - v if self.op == ">=" else v - self.bound
        return gap.clamp_min(0.0)

    @property
    def spec(self) -> str:
        return f"{self.metric}{self.op}{_fmt(self.bound)}"


@dataclasses.dataclass(frozen=True)
class Constrained(Objective):
    """Minimize ``primary`` subject to ``constraints``, with a
    feasibility fallback: feasible candidates always beat infeasible
    ones; among feasible ones the primary decides; if NO candidate is
    feasible, the least total violation wins (primary breaks exact
    violation ties) — the twin degrades gracefully instead of picking
    arbitrarily when the goal is unsatisfiable."""
    primary: Objective
    constraints: Tuple[Constraint, ...]
    elementwise = False

    def __post_init__(self) -> None:
        if not self.constraints:
            raise ValueError("constrained objective needs >= 1 constraint")

    def _violation(self, metrics: DrainMetrics) -> torch.Tensor:
        total = None
        for c in self.constraints:
            v = c.violation(metrics)
            total = v if total is None else total + v
        return total

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        return _rank_compose([self._violation(metrics),
                              self.primary.costs(metrics)])

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        out = {f"violation:{c.spec}": c.violation(metrics)
               for c in self.constraints}
        out.update(self.primary.cost_terms(metrics))
        return out

    @property
    def spec(self) -> str:
        return ("min:" + self.primary.spec
                + "".join("@" + c.spec for c in self.constraints))


_REDUCTIONS = ("mean", "worst", "regret", "quantile", "cvar")


def _fmt_level(v: float) -> str:
    """Exact round-trip float formatting with the trailing ``.0``
    dropped, so canonical specs read ``p95:`` rather than ``p95.0:``."""
    s = _fmt(v)
    return s[:-2] if s.endswith(".0") else s


@dataclasses.dataclass(frozen=True)
class Distributional(Objective):
    """A risk reduction of an inner goal over the Monte-Carlo fan axis
    (DESIGN.md §10).

    ``member_costs`` evaluates the inner goal per fan member (the
    candidate axis stays last, so rank-based inner goals compose ranks
    *within* each member), and ``reduce_fan`` collapses the fan axis
    (second-to-last) with the chosen reduction:

    * ``quantile`` — nearest-rank order statistic (``p95:`` = sorted
      member ``ceil(0.95·F) - 1``); exact, no interpolation, so device
      f32 results match a numpy oracle bitwise;
    * ``cvar``     — mean of the worst ``max(1, ceil((1-α)·F))`` sorted
      members (``α`` in ``level``): expected cost in the tail;
    * ``worst``    — max over members (robust / adversarial);
    * ``regret``   — minimax regret: per member subtract the best
      candidate's cost (common-random-number futures make the per-member
      min meaningful), then max over members;
    * ``mean``     — the risk-neutral default a plain goal lifts to
      under a fan (``as_distributional``).

    Deadlocked members carry ``+inf`` member costs, so a policy whose
    tail deadlocks is poisoned exactly as far into the distribution as
    the reduction looks (p50 forgives a rare deadlock, ``worst:`` never
    does).  Without a fan axis (plain decide/replay), ``costs`` / ``
    cost_terms`` degenerate to the inner goal.
    """
    reduction: str
    inner: Objective
    level: float = 0.0

    def __post_init__(self) -> None:
        if self.reduction not in _REDUCTIONS:
            raise ValueError(f"unknown fan reduction {self.reduction!r}; "
                             f"have {_REDUCTIONS}")
        if isinstance(self.inner, Distributional):
            raise ValueError("distributional reductions cannot nest: "
                             "there is only one fan axis")
        if self.reduction == "quantile" and not 0.0 < self.level <= 100.0:
            raise ValueError(
                f"quantile level must be in (0, 100], got {self.level!r}")
        if self.reduction == "cvar" and not 0.0 <= self.level < 1.0:
            raise ValueError(
                f"cvar alpha must be in [0, 1), got {self.level!r}")
        if self.reduction in ("mean", "worst", "regret") and self.level:
            raise ValueError(
                f"{self.reduction}: takes no level, got {self.level!r}")

    @property
    def elementwise(self) -> bool:  # type: ignore[override]
        return self.inner.elementwise

    # -- fan-axis interface (engine.fan_select) ------------------------

    def member_costs(self, metrics: DrainMetrics) -> torch.Tensor:
        """Inner costs per fan member — metrics shaped ``(..., F, k)``,
        candidates last, fan second-to-last."""
        return self.inner.costs(metrics)

    def reduce_fan(self, member_costs: torch.Tensor) -> torch.Tensor:
        """``(..., F, k)`` member costs -> ``(..., k)`` reduced costs.
        F is a trace-time constant, so the sorted-reduction indices are
        static Python integers."""
        F = member_costs.shape[-2]
        if self.reduction == "mean":
            return member_costs.mean(-2)
        if self.reduction == "worst":
            return member_costs.amax(-2)
        if self.reduction == "regret":
            best = member_costs.amin(-1, keepdim=True)
            reg = torch.where(torch.isfinite(member_costs),
                              member_costs - best, torch.inf)
            return reg.amax(-2)
        srt = torch.sort(member_costs, dim=-2).values
        if self.reduction == "quantile":
            return srt[..., quantile_index(self.level / 100.0, F), :]
        m = cvar_tail_count(self.level, F)
        return srt[..., F - m:, :].mean(-2)

    # -- degenerate (no fan axis) interface ----------------------------

    def costs(self, metrics: DrainMetrics) -> torch.Tensor:
        return self.inner.costs(metrics)

    def cost_terms(self, metrics: DrainMetrics) -> Dict[str, torch.Tensor]:
        return self.inner.cost_terms(metrics)

    @property
    def spec(self) -> str:
        if self.reduction == "quantile":
            return f"p{_fmt_level(self.level)}:{self.inner.spec}"
        if self.reduction == "cvar":
            return f"cvar:{_fmt_level(self.level)}:{self.inner.spec}"
        return f"{self.reduction}:{self.inner.spec}"


def as_distributional(objective: "ObjectiveLike") -> Distributional:
    """Lift any goal to a fan goal: distributional goals pass through,
    anything else wraps in the risk-neutral ``mean:`` reduction (so a
    plain ``"score"`` under an F=1 fan selects bit-identically to the
    fan-less path: the mean over a singleton axis is the identity)."""
    obj = normalize_objective(objective)
    if isinstance(obj, Distributional):
        return obj
    return Distributional("mean", obj)


#: The administrator default: the paper's own goal.
DEFAULT_OBJECTIVE = PaperScore()


# ----------------------------------------------------------------------
# Registry: named goals, extensible (a learned-θ reward registers here).
# ----------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Objective]] = {}


def register_objective(name: str, factory: Callable[[], Objective],
                       overwrite: bool = False) -> None:
    """Register a named goal for ``parse_objective``/configs/CLIs.
    ``factory`` is called per lookup (objectives are immutable, so a
    ``lambda: OBJ`` constant is fine)."""
    name = name.strip().lower()
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"objective {name!r} already registered")
    _REGISTRY[name] = factory


def registered_objectives() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_objective("score", lambda: PaperScore())
for _m in METRICS:
    register_objective(_m, lambda _m=_m: Weighted(((1.0, _m),)))
register_objective("util", lambda: Weighted(((1.0, "utilization"),)))


# ----------------------------------------------------------------------
# Grammar.
# ----------------------------------------------------------------------

def _parse_term(text: str) -> Tuple[float, str]:
    """``metric`` or ``coeff*metric`` (coeff may be negative)."""
    if "*" in text:
        c_s, m_s = text.split("*", 1)
        try:
            c = float(c_s)
        except ValueError:
            raise ValueError(f"bad coefficient {c_s!r} in term {text!r}")
        return c, _metric(m_s)
    return 1.0, _metric(text)


def _parse_expr(text: str) -> Objective:
    """``score[:field=val...]`` | weighted sum of metric terms."""
    text = text.strip()
    if not text:
        raise ValueError("empty objective expression")
    head = text.split(":", 1)[0].strip().lower()
    if head == "score":
        if ":" not in text:
            return PaperScore()
        kw: Dict[str, float] = {}
        for assign in text.split(":")[1:]:
            if "=" not in assign:
                raise ValueError(f"bad score weight {assign!r}; expected "
                                 f"field=value")
            key, val = assign.split("=", 1)
            key = key.strip().lower()
            if key not in ScoreWeights._fields:
                raise ValueError(
                    f"score weights index {ScoreWeights._fields}, "
                    f"got {key!r}")
            kw[key] = float(val)
        return PaperScore(PAPER_WEIGHTS._replace(**kw))
    lname = text.strip().lower()
    if lname in _REGISTRY:
        return _REGISTRY[lname]()
    terms = tuple(_parse_term(t.strip()) for t in text.split("+"))
    return Weighted(terms)


def _parse_constraint(text: str) -> Constraint:
    for op in _CONSTRAINT_OPS:
        if op in text:
            m_s, b_s = text.split(op, 1)
            return Constraint(_metric(m_s), op, float(b_s))
    raise ValueError(
        f"bad constraint {text!r}; expected metric>=bound or "
        f"metric<=bound")


_QUANTILE_RE = re.compile(r"^p(\d+(?:\.\d+)?):(.+)$", re.IGNORECASE)


def _match_distributional(
        text: str) -> Optional[Tuple[str, float, str]]:
    """``(reduction, level, inner_body)`` if ``text`` starts with a
    distributional prefix, else None.  Malformed prefixes (``cvar:``
    without an alpha) raise."""
    low = text.lower()
    for red in ("mean", "worst", "regret"):
        if low.startswith(red + ":"):
            return red, 0.0, text[len(red) + 1:]
    if low.startswith("cvar:"):
        rest = text[5:]
        if ":" not in rest:
            raise ValueError(
                f"bad cvar goal {text!r}; expected cvar:ALPHA:goal "
                f"(e.g. cvar:0.9:avg_wait)")
        a_s, body = rest.split(":", 1)
        try:
            alpha = float(a_s)
        except ValueError:
            raise ValueError(f"bad cvar alpha {a_s!r} in {text!r}")
        return "cvar", alpha, body
    m = _QUANTILE_RE.match(text)
    if m:
        return "quantile", float(m.group(1)), m.group(2)
    return None


def parse_objective(grammar: str) -> Objective:
    """Parse a goal grammar string (module docstring) into an
    ``Objective``.  ``obj.spec`` (== ``str(obj)``) round-trips:
    ``parse_objective(obj.spec) == obj``."""
    text = grammar.strip()
    if not text:
        raise ValueError("empty objective grammar")
    dist = _match_distributional(text)
    if dist is not None:
        red, level, body = dist
        body = body.strip()
        if not body:
            raise ValueError(f"empty inner goal in {text!r}")
        if _match_distributional(body) is not None:
            raise ValueError(
                f"distributional reductions cannot nest ({text!r}): "
                f"there is only one fan axis")
        return Distributional(red, parse_objective(body), level)
    low = text.lower()
    if low.startswith("lex:"):
        body = text[4:]
        if "@" in body:
            raise ValueError(
                "lex: goals do not take @constraints; constrain the "
                "whole goal as min:...@... with a single primary")
        # a single level raises in Lexicographic.__post_init__: a
        # one-level "lex:" is almost certainly a forgotten tie-break
        return Lexicographic(tuple(_parse_expr(p) for p in body.split(",")))
    if low.startswith("min:"):
        text = text[4:]
    if "@" in text:
        expr, *cons = text.split("@")
        return Constrained(_parse_expr(expr),
                           tuple(_parse_constraint(c) for c in cons))
    return _parse_expr(text)


def validate_objective(grammar: str) -> Objective:
    """Parse a goal grammar AND assert its canonical spec round-trips
    (``parse_objective(goal.spec) == goal``) — the one validation
    every CLI/entry point shares.  A round-trip failure is a grammar
    bug, not user error; raise so it cannot pass silently."""
    goal = parse_objective(grammar)
    if parse_objective(goal.spec) != goal:
        raise ValueError(
            f"objective grammar does not round-trip: {grammar!r} -> "
            f"{goal.spec!r} — report this as a grammar bug")
    return goal


#: Anything the public entry points accept as a goal.  ``ScoreWeights``
#: is the deprecated legacy spelling (lifted with a warning).
ObjectiveLike = Union[Objective, str, ScoreWeights, None]


def normalize_objective(objective: ObjectiveLike) -> Objective:
    """Coerce any goal spelling to an ``Objective``:

    * ``None``        — the default (the paper score);
    * ``Objective``   — returned as is;
    * ``str``         — grammar (``parse_objective``);
    * ``ScoreWeights``— deprecated: lifted to ``PaperScore(weights)``
      (bit-identical to the legacy path) with a ``DeprecationWarning``.
    """
    if objective is None:
        return DEFAULT_OBJECTIVE
    if isinstance(objective, Objective):
        return objective
    if isinstance(objective, ScoreWeights):
        warnings.warn(
            "passing ScoreWeights as the goal is deprecated; use "
            "objective=\"score\" (or PaperScore(weights) for custom "
            "weights) — decisions are bit-identical",
            DeprecationWarning, stacklevel=3)
        return PaperScore(objective)
    if isinstance(objective, str):
        return parse_objective(objective)
    raise TypeError(
        f"cannot interpret {type(objective).__name__} as an objective; "
        f"pass an Objective, a grammar string, or None")


def resolve_goal(objective: ObjectiveLike = None,
                 weights: Optional[ScoreWeights] = None) -> Objective:
    """The one shim behind every public entry point's
    ``(objective=, weights=)`` pair: a legacy ``weights=`` kwarg lifts
    to ``PaperScore(weights)`` with a ``DeprecationWarning``; passing
    both is an error."""
    if weights is not None:
        if objective is not None:
            raise ValueError(
                "pass either objective= or the deprecated weights=, "
                "not both")
        warnings.warn(
            "weights= is deprecated; pass objective=\"score\" (default) "
            "or objective=PaperScore(weights) — decisions are "
            "bit-identical",
            DeprecationWarning, stacklevel=3)
        return PaperScore(weights)
    return normalize_objective(objective)


# ----------------------------------------------------------------------
# Host-side report scoring (benchmarks: adaptive vs static).
# ----------------------------------------------------------------------

def metrics_from_rows(rows: Sequence[Mapping[str, float]]) -> DrainMetrics:
    """Stack metric dicts (e.g. ``RunReport.metric_dict()``) into a
    ``DrainMetrics`` with one (n,) candidate axis, so host-side reports
    score through the SAME cost semantics as the engine's
    decisions."""
    if not rows:
        raise ValueError("no metric rows")
    arr = lambda f: torch.tensor([float(r[f]) for r in rows],
                                 dtype=torch.float32)
    return DrainMetrics(**{f: arr(f) for f in METRICS})


def report_costs(objective: ObjectiveLike,
                 rows: Sequence[Mapping[str, float]]) -> np.ndarray:
    """(n,) costs of n metric-dict candidates under ``objective`` —
    relative order is what matters (rank-based goals return composed
    ranks)."""
    obj = normalize_objective(objective)
    return obj.costs(metrics_from_rows(rows)).numpy()
