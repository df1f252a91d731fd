"""The population trainer: close the θ loop on the device (DESIGN.md §13)
— port of ``repro/learn/trainer.py``, the same loop on the port's engine
(``cuda`` by default; K1 runs every pass of every generation's grids).

Each generation, N candidate θ (plus, at gen 0, the family's static
fixed points as warm-start rows) ride the FORK axis of ONE batched
``engine.generation_costs`` grid over S training scenarios — the
strategy never sees a rollout, only the (S, N) cost table.  Model
selection is a separate concern from search: the deployed θ is the
best candidate EVER seen on the held-out scenarios, the strategy is
told only training fitness, and early stopping fires when held-out
stops improving.

Pool-relative goals: lexicographic / constrained objectives cost
composed RANKS within the evaluated pool, which is exactly the
ordering selection strategies need — but such costs are not comparable
across different pools.  The trainer therefore always appends the
current incumbent θ to the held-out evaluation pool and compares
WITHIN one grid; absolute-cost curve fields are meaningful when
``goal.elementwise`` (true for all plain/weighted/distributional
goals) and pool-relative otherwise.

Checkpoints (``checkpoint/manager.py``) hold the strategy state, the
incumbent θ, and the full history; all randomness is keyed on
``(seed, generation)`` (``strategy.draw_eps``), so resume needs no RNG
state and a resumed run is bitwise the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.checkpoint.manager import (ARRAYS, MANIFEST,
                                            CheckpointManager, step_dir)
from repro_torch.core import policies
from repro_torch.core.objective import resolve_goal
from repro_torch.core.policies import (FAMILY_NAMES, N_THETA, PolicyPool,
                                       describe_spec, theta_pool)
from repro_torch.device import DeviceLike
from repro_torch.learn.evolution import ParamSpace, family_space, static_seeds
from repro_torch.learn.strategy import CEM, ES, StrategyState

#: name under which trainer metadata rides a checkpoint manifest
EXTRA_KEY = "learn"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of one training run (JSON-safe by design)."""

    family: str = "lin"            # "lin" | "wfp" | "expf"
    strategy: str = "cem"          # "cem" | "es"
    population: int = 16
    generations: int = 24
    objective: str = "score"       # objective grammar (or Objective)
    seed: int = 0
    sigma_scale: float = 1.0       # scales the space's default sigma0
    lr: float = 1.0                # ES step size
    sigma_decay: float = 1.0       # ES per-gen sigma shrink
    elite_frac: float = 0.25       # CEM elite fraction
    antithetic: bool = True        # paired ±eps draws (variance reduction)
    warm_start: bool = True        # inject static fixed points at gen 0
    fan: Any = None                # FanSpec: domain-randomize training traces
    patience: int = 6              # held-out early stop (0 = off)

    def make_strategy(self):
        kind = self.strategy.strip().lower()
        if kind == "es":
            return ES(population=self.population, seed=self.seed,
                      lr=self.lr, antithetic=self.antithetic,
                      sigma_decay=self.sigma_decay)
        if kind == "cem":
            return CEM(population=self.population, seed=self.seed,
                       elite_frac=self.elite_frac,
                       antithetic=self.antithetic)
        raise ValueError(f"unknown strategy {self.strategy!r}; "
                         f"have 'cem', 'es'")


@dataclasses.dataclass
class TrainResult:
    """Outcome of ``train``: the deployable incumbent + its audit trail."""

    pool: PolicyPool               # k=1 pool of the incumbent θ
    theta: np.ndarray              # (N_THETA,) incumbent
    family: str
    label: str                     # pool display name
    best_heldout: float            # incumbent held-out cost (see module doc)
    best_train: float
    best_desc: str                 # describe_spec of the incumbent
    history: List[Dict[str, Any]]  # one record per generation
    generations_run: int
    stopped_early: bool
    checkpoint_dir: Optional[str]


def _aggregate(costs) -> np.ndarray:
    """(S, P) per-scenario costs -> (P,) fitness: mean over scenarios
    in float64 (deadlocked rollouts are +inf and propagate)."""
    if isinstance(costs, torch.Tensor):
        costs = costs.detach().cpu().numpy()
    return np.asarray(costs, np.float64).mean(axis=0)


def _gen0_extras(space: ParamSpace, config: TrainConfig
                 ) -> Tuple[List[str], List[np.ndarray]]:
    """Warm-start rows riding the gen-0 grid (never given to tell()):
    the family's static fixed points, plus the search-space origin
    ``x0`` as the explicit "init" baseline the learning curve and the
    improvement gate measure against."""
    names: List[str] = ["init"]
    thetas: List[np.ndarray] = [
        space.decode(np.asarray(space.x0, np.float32)[None, :])[0]]
    if config.warm_start:
        for name, th in static_seeds(space.family):
            names.append(name)
            thetas.append(th)
    return names, thetas


def train(train_scenarios, heldout_scenarios, config: TrainConfig, *,
          engine=None, eval_fn: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
          resume: bool = False,
          log_fn: Optional[Callable[[str], None]] = None,
          device: DeviceLike = "cuda") -> TrainResult:
    """Run the ES/CEM loop; returns the held-out incumbent.

    ``eval_fn(scenarios, pool_spec) -> (S, P) costs`` overrides the
    generation evaluator (e.g. ``whatif.sharded_generation_costs``, the
    block-streamed one, which gives the same θ bitwise);
    the default is the one-shot ``engine.generation_costs`` with
    ``config.fan`` riding along, on ``engine`` or else a
    ``DrainEngine`` on ``device``.
    ``resume=True`` continues from the latest checkpoint under
    ``checkpoint_dir`` (bitwise the uninterrupted run).
    """
    goal = resolve_goal(config.objective)
    space = family_space(config.family)
    family_name = FAMILY_NAMES[space.family]
    strat = config.make_strategy()
    say = log_fn or (lambda msg: None)

    if eval_fn is None:
        from repro_torch.core.engine import DrainEngine
        eng = engine if engine is not None else DrainEngine(device=device)
        eval_fn = lambda scen, pool: eng.generation_costs(
            scen, pool, goal, config.fan)

    sigma0 = np.asarray(space.sigma0, np.float32) * np.float32(config.sigma_scale)
    state = strat.init(np.asarray(space.x0, np.float32), sigma0)
    history: List[Dict[str, Any]] = []
    best_theta: Optional[np.ndarray] = None
    best_name = ""
    best_train = float("inf")
    best_heldout = float("inf")
    stall = 0
    start_gen = 0
    train_curve_floor = float("inf")  # running min -> monotone curves
    cand_curve_floor = float("inf")   # candidates only (search progress)

    manager = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    if resume:
        if manager is None:
            raise ValueError("resume=True needs a checkpoint_dir")
        restored = _restore(manager, space, config)
        if restored is not None:
            (state, best_theta, best_name, best_train, best_heldout,
             stall, start_gen, history) = restored
            train_curve_floor = min(
                [r["train_best_so_far"] for r in history] or [float("inf")])
            cand_curve_floor = min(
                [r["cand_best_so_far"] for r in history] or [float("inf")])
            say(f"resumed gen {start_gen} from {checkpoint_dir}")

    stopped_early = False
    last_saved = -1
    g = start_gen - 1   # if already at the generation budget (resume)
    for g in range(start_gen, config.generations):
        z = strat.ask(state)                       # (N, D) search points
        cand_thetas = space.decode(z)              # (N, N_THETA)
        extra_names: List[str] = []
        extra_thetas: List[np.ndarray] = []
        if g == 0:
            extra_names, extra_thetas = _gen0_extras(space, config)
        all_thetas = (np.concatenate([cand_thetas, np.stack(extra_thetas)])
                      if extra_thetas else cand_thetas)
        all_names = [f"cand{i}" for i in range(len(cand_thetas))] + extra_names

        grid_pool = theta_pool(space.family, all_thetas, all_names)
        fit = _aggregate(eval_fn(train_scenarios, grid_pool.spec))

        # Held-out model selection: same candidates + the incumbent in
        # ONE grid, so the comparison is within-pool even for
        # rank-based goals.
        h_thetas, h_names = all_thetas, list(all_names)
        inc_col = None
        if best_theta is not None:
            h_thetas = np.concatenate([all_thetas, best_theta[None, :]])
            h_names = h_names + ["incumbent"]
            inc_col = len(h_names) - 1
        hfit = _aggregate(eval_fn(
            heldout_scenarios, theta_pool(space.family, h_thetas,
                                          h_names).spec))
        cand_h = hfit[:len(all_thetas)]
        pick = int(np.argmin(np.where(np.isfinite(cand_h), cand_h, np.inf)))
        improved = bool(np.isfinite(cand_h[pick])) and (
            inc_col is None or bool(cand_h[pick] < hfit[inc_col]))
        if improved:
            best_theta = np.asarray(all_thetas[pick], np.float32).copy()
            best_name = all_names[pick]
            best_train = float(fit[pick])
            best_heldout = float(cand_h[pick])
            stall = 0
        else:
            best_heldout = float(hfit[inc_col]) if inc_col is not None \
                else best_heldout
            stall += 1

        state = strat.tell(state, z, fit[:strat.population])

        train_best = float(np.min(fit))
        cand_best = float(np.min(fit[:strat.population]))
        train_curve_floor = min(train_curve_floor, train_best)
        cand_curve_floor = min(cand_curve_floor, cand_best)
        finite = fit[:strat.population][np.isfinite(fit[:strat.population])]
        history.append({
            "gen": g,
            "train_best": train_best,
            "train_best_so_far": train_curve_floor,
            "cand_best": cand_best,
            "cand_best_so_far": cand_curve_floor,
            "train_mean": float(finite.mean()) if finite.size else float("inf"),
            "heldout_best": float(np.min(cand_h)),
            "incumbent_heldout": best_heldout,
            "incumbent": best_name,
            "improved": bool(improved),
            "sigma_mean": float(np.asarray(state.sigma, np.float64).mean()),
        })
        say(f"gen {g:3d}  train best {train_best:.6g}  "
            f"held-out incumbent {best_heldout:.6g} ({best_name})"
            f"{'  *' if improved else ''}")

        if manager is not None and checkpoint_every > 0 and (
                (g + 1) % checkpoint_every == 0
                or g + 1 == config.generations):
            _save(manager, g + 1, state, config, goal, family_name,
                  best_theta, best_name, best_train, best_heldout,
                  stall, history)
            last_saved = g + 1
        if config.patience > 0 and stall >= config.patience:
            stopped_early = True
            say(f"early stop: held-out flat for {stall} generations")
            break

    if best_theta is None:
        raise RuntimeError(
            "training produced no finite-cost candidate (every rollout "
            "deadlocked?) — check the traces fit the cluster")
    if manager is not None and checkpoint_every > 0 and last_saved != g + 1:
        _save(manager, g + 1, state, config, goal, family_name,
              best_theta, best_name, best_train, best_heldout, stall,
              history)

    label = f"trained[{family_name}]"
    desc = describe_spec(space.family, best_theta)
    return TrainResult(
        pool=theta_pool(space.family, best_theta[None, :], (label,)),
        theta=best_theta, family=family_name, label=label,
        best_heldout=best_heldout, best_train=best_train, best_desc=desc,
        history=history, generations_run=g + 1,
        stopped_early=stopped_early, checkpoint_dir=checkpoint_dir)


# ----------------------------------------------------------------------
# Checkpoint round-trip
# ----------------------------------------------------------------------

def _save(manager: CheckpointManager, step: int, state: StrategyState,
          config: TrainConfig, goal, family_name: str,
          best_theta: Optional[np.ndarray], best_name: str,
          best_train: float, best_heldout: float, stall: int,
          history: List[Dict[str, Any]]) -> None:
    tree = {
        "mean": np.asarray(state.mean, np.float32),
        "sigma": np.asarray(state.sigma, np.float32),
        "best_theta": (np.asarray(best_theta, np.float32)
                       if best_theta is not None
                       else np.zeros((N_THETA,), np.float32)),
    }
    cfg = dataclasses.asdict(config)
    cfg["objective"] = goal.spec
    cfg["fan"] = None if config.fan is None else repr(config.fan)
    extra = {EXTRA_KEY: {
        "version": 1,
        "family": family_name,
        "objective": goal.spec,
        "gen": step,
        "stall": stall,
        "has_best": best_theta is not None,
        "best_name": best_name,
        "best_desc": (describe_spec(policies._FAMILY_BY_NAME[family_name],
                                    best_theta)
                      if best_theta is not None else ""),
        "best_train": best_train,
        "best_heldout": best_heldout,
        "config": cfg,
        "history": history,
    }}
    json.dumps(extra)  # fail fast on non-JSON-safe state, not mid-save
    manager.save(step, tree, extra)


def _restore(manager: CheckpointManager, space: ParamSpace,
             config: TrainConfig):
    step = manager.latest_step()
    if step is None:
        return None
    target = {
        "mean": np.zeros((space.dim,), np.float32),
        "sigma": np.zeros((space.dim,), np.float32),
        "best_theta": np.zeros((N_THETA,), np.float32),
    }
    tree, extra = manager.restore(step, target, device="cpu")
    meta = extra.get(EXTRA_KEY)
    if not meta:
        raise ValueError(
            f"checkpoint step {step} has no {EXTRA_KEY!r} metadata — "
            f"not a trainer checkpoint")
    if meta["family"] != FAMILY_NAMES[space.family]:
        raise ValueError(
            f"checkpoint family {meta['family']!r} != configured "
            f"{FAMILY_NAMES[space.family]!r}")
    state = StrategyState(mean=tree["mean"].numpy(),
                          sigma=tree["sigma"].numpy(),
                          gen=int(meta["gen"]))
    best_theta = (tree["best_theta"].numpy()
                  if meta.get("has_best") else None)
    return (state, best_theta, meta.get("best_name", ""),
            float(meta.get("best_train", float("inf"))),
            float(meta.get("best_heldout", float("inf"))),
            int(meta.get("stall", 0)), int(meta["gen"]),
            list(meta.get("history", [])))


def load_trained_pool(path: str) -> PolicyPool:
    """Load the incumbent θ of a trainer checkpoint directory as a k=1
    ``PolicyPool`` — the ``trained:<ckpt>`` grammar entry and
    ``twin_loop --pool trained:<path>`` resolve through here."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path!r}")
    manager = CheckpointManager(path)
    step = manager.latest_step()
    if step is None:
        raise ValueError(f"no valid checkpoint under {path!r}")
    # read the θ leaf + metadata directly — the search-state leaves
    # have family-dependent dims the loader need not know about
    d = step_dir(path, step)
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest.get("extra", {}).get(EXTRA_KEY)
    if not meta:
        raise ValueError(
            f"{path!r} step {step} is not a trainer checkpoint "
            f"(no {EXTRA_KEY!r} metadata)")
    if not meta.get("has_best"):
        raise ValueError(
            f"{path!r} step {step} holds no trained policy yet")
    data = np.load(os.path.join(d, ARRAYS))
    theta = np.asarray(data["best_theta"], np.float32)
    family = policies._FAMILY_BY_NAME[meta["family"]]
    return theta_pool(family, theta[None, :],
                      (f"trained[{meta['family']}]",))
