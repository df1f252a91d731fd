"""Scheduling policy space — port of ``repro/core/policies.py``.

A policy is a *priority key function*: lower key = scheduled earlier.
Two representations, as in the reference:

* **Integer policy ids** (``WFP`` ... ``EXPF``, ``priority_key``) — the
  original 7-row key stack, kept as the oracle the parametric path is
  checked against.
* **``PolicySpec``** ``(family, theta)``: key = Φ·θ_lin + a
  family-specific nonlinear term.  The 7 statics are fixed points whose
  keys equal the id stack bit for bit (one-hot weights, and ``_pow``
  special-cases the small integer exponents).

Every key function broadcasts over leading axes: ``jobs`` fields may be
(J,) or (k, J), ``now``/``family`` () or (k,), ``theta`` (N_THETA,) or
(k, N_THETA).  That replaces the reference's ``jax.vmap`` over forks.

The linear term Φ·θ_lin is written as six products summed left to
right, never as a matmul, so no TF32 or reordered reduction can enter
it on the card.  Pools are host tensors (CPU); the engine copies them to
its device.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.state import JobTable

# Canonical ids — tie-break order is numeric order (paper §4.2).
WFP = 0    # ALCF utility: run job maximizing (wait/est)^3 * nodes
FCFS = 1   # first-come-first-served
SJF = 2    # shortest (estimated) job first
# --- beyond-paper pool extensions ---
SAF = 3    # smallest area (nodes * est) first
LJF = 4    # longest job first
LXF = 5    # largest expansion factor first: (wait + est) / est
EXPF = 6   # exponential aging of wait time

POLICY_NAMES = {
    WFP: "WFP", FCFS: "FCFS", SJF: "SJF",
    SAF: "SAF", LJF: "LJF", LXF: "LXF", EXPF: "EXPF",
}
PAPER_POOL: Sequence[int] = (WFP, FCFS, SJF)
EXTENDED_POOL: Sequence[int] = (WFP, FCFS, SJF, SAF, LJF, LXF, EXPF)

_EST_FLOOR = 1.0  # seconds; guards division by tiny estimates


def _wait_est_nodes(jobs: JobTable, now: torch.Tensor):
    now = torch.as_tensor(now, dtype=torch.float32,
                          device=jobs.submit_t.device)
    wait = (now[..., None] - jobs.submit_t).clamp_min(0.0)
    est = jobs.est_runtime.clamp_min(_EST_FLOOR)
    nodes = jobs.nodes.to(torch.float32)
    return wait, est, nodes


def priority_key(jobs: JobTable, now, policy_id) -> torch.Tensor:
    """Per-job priority keys (lower = run first) for integer
    ``policy_id`` (a scalar or one id per fork).  Stable argsort over
    slot ids means ties fall back to FCFS order."""
    wait, est, nodes = _wait_est_nodes(jobs, now)
    ratio = wait / est
    wfp_score = ratio * ratio * ratio * nodes      # lax.integer_pow(., 3)
    lxf_score = (wait + est) / est
    expf_score = torch.expm1((wait / 3600.0).clamp_max(30.0))
    keys = torch.stack([
        -wfp_score,                               # WFP
        jobs.submit_t.expand_as(wait),            # FCFS
        est.expand_as(wait),                      # SJF
        (nodes * est).expand_as(wait),            # SAF
        -est.expand_as(wait),                     # LJF
        -lxf_score,                               # LXF
        -expf_score,                              # EXPF
    ], dim=-2)                                    # (..., 7, J)
    pid = torch.as_tensor(policy_id, dtype=torch.int64, device=wait.device)
    lead = torch.broadcast_shapes(keys.shape[:-2], pid.shape)
    keys = keys.expand(lead + keys.shape[-2:])
    idx = pid[..., None, None].expand(lead + (1, keys.shape[-1]))
    return torch.gather(keys, -2, idx).squeeze(-2)


# ======================================================================
# Parametric policy space: PolicySpec = (family, theta)
# ======================================================================

#: Feature-matrix columns (order = θ linear-weight layout).
FEATURES: Tuple[str, ...] = ("wait", "est", "nodes", "area", "xfactor",
                             "submit")
N_FEATURES = len(FEATURES)

TH_A = N_FEATURES        # WFP family: exponent on wait/est
TH_B = N_FEATURES + 1    # WFP family: exponent on nodes
TH_TAU = N_FEATURES + 2  # WFP/EXP families: aging timescale (seconds)
N_THETA = N_FEATURES + 3

AGING_CAP = 30.0  # cap on wait/tau before exp() — matches legacy EXPF

FAM_LIN = 0   # key = Φ·θ_lin                     (FCFS/SJF/SAF/LJF/LXF)
FAM_WFP = 1   # key = Φ·θ_lin - (wait/est)^a · nodes^b · e^min(wait/τ,cap)
FAM_EXP = 2   # key = Φ·θ_lin - expm1(min(wait/τ, cap))        (EXPF)

FAMILY_NAMES = {FAM_LIN: "lin", FAM_WFP: "wfp", FAM_EXP: "expf"}

FAMILY_PARAMS: Dict[int, Dict[str, Tuple[int, float]]] = {
    FAM_LIN: {},
    FAM_WFP: {"a": (TH_A, 3.0), "b": (TH_B, 1.0), "tau": (TH_TAU, np.inf)},
    FAM_EXP: {"tau": (TH_TAU, 3600.0)},
}


class PolicySpec(NamedTuple):
    """One policy fork (or a stacked pool of k forks) in parameter space.

    ``family`` — i32, scalar (one fork) or (k,) (a pool).
    ``theta``  — f32, (N_THETA,) or (k, N_THETA).
    """
    family: torch.Tensor
    theta: torch.Tensor

    def to(self, device) -> "PolicySpec":
        return PolicySpec(self.family.to(device), self.theta.to(device))


def job_features(jobs: JobTable, now) -> torch.Tensor:
    """The (..., J, N_FEATURES) feature matrix Φ; columns follow
    ``FEATURES``, ``est`` floored at ``_EST_FLOOR``."""
    return torch.stack(_feature_columns(jobs, now), dim=-1)


def _feature_columns(jobs: JobTable, now) -> List[torch.Tensor]:
    wait, est, nodes = _wait_est_nodes(jobs, now)
    return [wait, est.expand_as(wait), nodes.expand_as(wait),
            (nodes * est).expand_as(wait), (wait + est) / est,
            jobs.submit_t.expand_as(wait)]


def _pow(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x^p with exact products for exponents 1, 2 and 3 (``x*x*x`` is
    what ``lax.integer_pow`` lowers to); other exponents use ``pow``.
    Every branch is evaluated; x >= 0, so none yields a NaN."""
    return torch.where(p == 1.0, x,
           torch.where(p == 2.0, x * x,
           torch.where(p == 3.0, x * x * x, torch.pow(x, p))))


def priority_key_spec(jobs: JobTable, now, spec: PolicySpec) -> torch.Tensor:
    """Per-job priority keys (..., J): Φ·θ_lin plus the family's
    negated nonlinear utility."""
    cols = _feature_columns(jobs, now)
    theta = spec.theta
    lin = cols[0] * theta[..., 0, None]
    for c in range(1, N_FEATURES):           # left-to-right, no matmul
        lin = lin + cols[c] * theta[..., c, None]
    wait, est, nodes = cols[0], cols[1], cols[2]
    a = theta[..., TH_A, None]
    b = theta[..., TH_B, None]
    tau = theta[..., TH_TAU, None]
    aged = (wait / tau).clamp_max(AGING_CAP)            # 0 when tau=inf
    wfp_nl = -(_pow(wait / est, a) * _pow(nodes, b) * torch.exp(aged))
    exp_nl = -torch.expm1(aged)
    fam = spec.family[..., None]
    nl = torch.where(fam == FAM_WFP, wfp_nl,
         torch.where(fam == FAM_EXP, exp_nl, torch.zeros_like(wfp_nl)))
    return lin + nl


def batched_priority_keys(jobs: JobTable, now,
                          pool_spec: PolicySpec) -> torch.Tensor:
    """(k, J) priority keys for a whole pool against ONE shared
    snapshot."""
    return priority_key_spec(
        JobTable(*(x[None, :] for x in jobs)),
        torch.as_tensor(now).reshape(1), pool_spec)


# ----------------------------------------------------------------------
# Time-invariance: which forks' keys never depend on ``now``?
# ----------------------------------------------------------------------

STATIC_KEY_IDS = frozenset({FCFS, SJF, SAF, LJF})

_WAIT_COL = FEATURES.index("wait")
_XF_COL = FEATURES.index("xfactor")

#: ``time_invariant_mask`` memo keyed by the pool leaves' ids, evicted
#: when a leaf dies (``weakref.finalize``): a pool on the card costs one
#: device-to-host copy the first time, none on later cycles.
_TI_MASK_CACHE: dict = {}


def time_invariant_mask(pool) -> np.ndarray:
    """Host-side (k,) bool: forks whose keys are independent of the
    clock (``lin`` family with zero ``wait``/``xfactor`` weight, or a
    legacy id in ``STATIC_KEY_IDS``), so their argsort can be hoisted
    out of the per-event loop."""
    leaves = ((pool.family, pool.theta) if isinstance(pool, PolicySpec)
              else (pool,))
    key = tuple(id(leaf) for leaf in leaves)
    hit = _TI_MASK_CACHE.get(key)
    if hit is not None:
        return hit
    if isinstance(pool, PolicySpec):
        fam = pool.family.detach().cpu().numpy().reshape(-1)
        th = pool.theta.detach().cpu().numpy().reshape(fam.shape[0], -1)
        mask = ((fam == FAM_LIN)
                & (th[:, _WAIT_COL] == 0.0)
                & (th[:, _XF_COL] == 0.0))
    else:
        ids = np.asarray(torch.as_tensor(pool).cpu()).reshape(-1)
        mask = np.isin(ids, sorted(STATIC_KEY_IDS))
    mask.setflags(write=False)
    if all(isinstance(leaf, torch.Tensor) for leaf in leaves):
        for leaf in leaves:
            weakref.finalize(leaf, _TI_MASK_CACHE.pop, key, None)
        _TI_MASK_CACHE[key] = mask
    return mask


# ----------------------------------------------------------------------
# Spec constructors: families and the 7 static fixed points.
# ----------------------------------------------------------------------

def _base_theta() -> np.ndarray:
    th = np.zeros((N_THETA,), dtype=np.float32)
    th[TH_TAU] = np.inf  # aged = wait/inf = 0: aging off by default
    return th


def _spec(family: int, th: np.ndarray) -> PolicySpec:
    return PolicySpec(torch.tensor(family, dtype=torch.int32),
                      torch.from_numpy(th))


def linear_spec(**weights: float) -> PolicySpec:
    """`lin` family: key = Σ w_f · feature_f."""
    th = _base_theta()
    for name, w in weights.items():
        if name not in FEATURES:
            raise ValueError(f"unknown feature {name!r}; have {FEATURES}")
        th[FEATURES.index(name)] = w
    return _spec(FAM_LIN, th)


def wfp_spec(a: float = 3.0, b: float = 1.0,
             tau: float = np.inf) -> PolicySpec:
    """`wfp` family: key = -(wait/est)^a · nodes^b · e^min(wait/τ, cap)."""
    if tau <= 0:
        raise ValueError(f"wfp tau must be > 0, got {tau}")
    th = _base_theta()
    th[TH_A], th[TH_B], th[TH_TAU] = a, b, tau
    return _spec(FAM_WFP, th)


def exp_spec(tau: float = 3600.0) -> PolicySpec:
    """`expf` family: key = -expm1(min(wait/τ, cap))."""
    if tau <= 0:
        raise ValueError(f"expf tau must be > 0, got {tau}")
    th = _base_theta()
    th[TH_TAU] = tau
    return _spec(FAM_EXP, th)


_STATIC_SPECS = {
    WFP: lambda: wfp_spec(),
    FCFS: lambda: linear_spec(submit=1.0),
    SJF: lambda: linear_spec(est=1.0),
    SAF: lambda: linear_spec(area=1.0),
    LJF: lambda: linear_spec(est=-1.0),
    LXF: lambda: linear_spec(xfactor=-1.0),
    EXPF: lambda: exp_spec(),
}


def static_spec(policy_id: int) -> PolicySpec:
    """The parametric fixed point of one integer policy id."""
    return _STATIC_SPECS[int(policy_id)]()


def stack_specs(specs: Sequence[PolicySpec]) -> PolicySpec:
    """Stack scalar specs into a pool with a leading fork axis."""
    if not specs:
        raise ValueError("empty policy pool")
    return PolicySpec(family=torch.stack([s.family for s in specs]),
                      theta=torch.stack([s.theta for s in specs]))


def describe_spec(family: int, theta) -> str:
    """Human-readable name for one fork: canonical static names where
    θ sits exactly on a fixed point, else ``family[k=v,...]``."""
    family = int(family)
    theta = np.asarray(theta.cpu() if isinstance(theta, torch.Tensor)
                       else theta)
    for pid, ctor in _STATIC_SPECS.items():
        ref = ctor()
        if int(ref.family) == family and np.array_equal(
                ref.theta.numpy(), theta.astype(np.float32)):
            return POLICY_NAMES[pid]
    parts = []
    if family == FAM_LIN:
        for i, fname in enumerate(FEATURES):
            if theta[i] != 0.0:
                parts.append(f"{fname}={theta[i]:g}")
    else:
        for pname, (idx, default) in FAMILY_PARAMS[family].items():
            if theta[idx] != np.float32(default):
                parts.append(f"{pname}={theta[idx]:g}")
    base = FAMILY_NAMES[family]
    return f"{base}[{','.join(parts)}]" if parts else base


# ----------------------------------------------------------------------
# PolicyPool: the user-facing pool (specs + display names) + grammar.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PolicyPool:
    """A candidate pool: stacked ``PolicySpec`` + per-fork names.  Pool
    position is tie-break priority."""
    spec: PolicySpec
    names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.names) != self.spec.family.shape[0]:
            raise ValueError(
                f"{len(self.names)} names for "
                f"{self.spec.family.shape[0]} forks")

    def __len__(self) -> int:
        return self.spec.family.shape[0]

    @property
    def size(self) -> int:
        return len(self)

    def __add__(self, other: "PolicyPool") -> "PolicyPool":
        return PolicyPool(
            spec=PolicySpec(
                torch.cat([self.spec.family, other.spec.family]),
                torch.cat([self.spec.theta, other.spec.theta])),
            names=self.names + other.names)

    def fork(self, p: int) -> PolicySpec:
        return PolicySpec(self.spec.family[p], self.spec.theta[p])

    @classmethod
    def from_ids(cls, ids: Sequence[int]) -> "PolicyPool":
        ids = [int(i) for i in np.asarray(list(ids))]
        return cls(spec=stack_specs([static_spec(i) for i in ids]),
                   names=tuple(POLICY_NAMES[i] for i in ids))

    @classmethod
    def from_specs(cls, specs: Sequence[PolicySpec],
                   names: Sequence[str] | None = None) -> "PolicyPool":
        pool = stack_specs(list(specs))
        if names is None:
            names = [describe_spec(s.family, s.theta) for s in specs]
        return cls(spec=pool, names=tuple(names))


_STATIC_BY_NAME = {POLICY_NAMES[i].lower(): i for i in EXTENDED_POOL}
_FAMILY_BY_NAME = {v: k for k, v in FAMILY_NAMES.items()}


def _parse_values(text: str) -> List[float]:
    """``v`` -> [v];  ``lo..hixN`` -> linspace(lo, hi, N)."""
    if ".." in text:
        lo_s, rest = text.split("..", 1)
        if "x" not in rest:
            raise ValueError(
                f"sweep {text!r} must be 'lo..hixN' (e.g. 1..5x5)")
        hi_s, n_s = rest.rsplit("x", 1)
        n = int(n_s)
        if n < 2:
            raise ValueError(f"sweep {text!r} needs >= 2 points")
        return [float(v) for v in np.linspace(float(lo_s), float(hi_s), n)]
    return [float(text)]


def parse_pool(grammar: str) -> PolicyPool:
    """Expand a pool grammar into a PolicyPool — one fork per grid point
    (same grammar as the reference: ``paper``, ``extended``, static
    names, ``wfp:a=1..5x5:tau=600..7200x5``, ``expf:tau=600``,
    ``lin:est=1:wait=-0.01``).  ``trained:<ckpt>`` is not ported yet.
    Term order is tie-break priority."""
    specs: List[PolicySpec] = []
    names: List[str] = []
    for term in (t.strip() for t in grammar.split(",")):
        if not term:
            continue
        if term.lower().startswith("trained:"):
            raise NotImplementedError(
                "trained:<ckpt> pools are not yet ported to repro_torch "
                "(ROADMAP A9)")
        head, *assigns = term.split(":")
        name = head.strip().lower()
        if not assigns:
            if name == "paper":
                ids = PAPER_POOL
            elif name == "extended":
                ids = EXTENDED_POOL
            elif name in _STATIC_BY_NAME:
                ids = (_STATIC_BY_NAME[name],)
            elif name in _FAMILY_BY_NAME:
                fam = _FAMILY_BY_NAME[name]
                spec = {FAM_LIN: linear_spec, FAM_WFP: wfp_spec,
                        FAM_EXP: exp_spec}[fam]()
                specs.append(spec)
                names.append(describe_spec(spec.family, spec.theta))
                continue
            else:
                raise ValueError(
                    f"unknown pool term {head!r}; statics: "
                    f"{sorted(_STATIC_BY_NAME)}, families: "
                    f"{sorted(_FAMILY_BY_NAME)}")
            for pid in ids:
                specs.append(static_spec(pid))
                names.append(POLICY_NAMES[pid])
            continue

        if name in _FAMILY_BY_NAME:
            fam = _FAMILY_BY_NAME[name]
        else:
            raise ValueError(
                f"term {head!r} takes no parameters; parametric "
                f"families: {sorted(_FAMILY_BY_NAME)}")

        keys: List[str] = []
        grids: List[List[float]] = []
        for assign in assigns:
            if "=" not in assign:
                raise ValueError(f"bad assignment {assign!r} in {term!r}")
            key, val = assign.split("=", 1)
            key = key.strip().lower()
            if fam == FAM_LIN:
                if key not in FEATURES:
                    raise ValueError(
                        f"lin weights index features {FEATURES}, "
                        f"got {key!r}")
            elif key not in FAMILY_PARAMS[fam]:
                raise ValueError(
                    f"{FAMILY_NAMES[fam]!r} params are "
                    f"{sorted(FAMILY_PARAMS[fam])}, got {key!r}")
            keys.append(key)
            grids.append(_parse_values(val.strip()))

        for combo in itertools.product(*grids):
            kw = dict(zip(keys, combo))
            if fam == FAM_LIN:
                spec = linear_spec(**kw)
            elif fam == FAM_WFP:
                spec = wfp_spec(**kw)
            else:
                spec = exp_spec(**kw)
            specs.append(spec)
            label = ",".join(f"{k}={v:g}" for k, v in zip(keys, combo))
            names.append(f"{FAMILY_NAMES[fam]}[{label}]")
    return PolicyPool.from_specs(specs, names)


PoolLike = Union["PolicyPool", PolicySpec, str, torch.Tensor,
                 np.ndarray, Sequence[int]]


def normalize_pool(pool: PoolLike) -> PolicyPool:
    """Coerce any pool representation to a PolicyPool (a PolicyPool, a
    stacked or scalar PolicySpec, a grammar string, or legacy ids)."""
    if isinstance(pool, PolicyPool):
        return pool
    if isinstance(pool, PolicySpec):
        if pool.family.ndim == 0:  # scalar fork -> k=1 pool
            pool = PolicySpec(pool.family.reshape(1),
                              pool.theta.reshape(1, -1))
        fam = pool.family.cpu().numpy()
        th = pool.theta.cpu().numpy()
        return PolicyPool(
            spec=pool,
            names=tuple(describe_spec(fam[i], th[i])
                        for i in range(fam.shape[0])))
    if isinstance(pool, str):
        return parse_pool(pool)
    if isinstance(pool, torch.Tensor):
        pool = pool.cpu().numpy()
    return PolicyPool.from_ids(pool)
