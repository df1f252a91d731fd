"""Population-search strategies behind one ``Strategy`` protocol — port of
``repro/learn/strategy.py``.  ``ask``/``tell`` are host numpy, as in the
reference (vectors of at most 9 dimensions); the draws come from the
port's threefry (``core/prng.py``), bitwise ``jax.random``'s.

Both strategies are *selection/recombination* methods: they only need a
fitness ORDERING over candidates, so they compose with every
``core.objective`` goal — including rank-based lexicographic and
constrained goals whose costs are pool-relative composed ranks.

Key discipline (mirrors ``core/fan.py``): every draw is keyed

    fold_in(fold_in(PRNGKey(seed), generation), candidate)

so populations are deterministic, resumable from ``(seed, gen)`` alone
(no RNG state lives in checkpoints), and *prefix-stable*: the first N
candidates of a population of M > N are bitwise the candidates of the
population of N. Antithetic pairing keeps the property — candidates
(2j, 2j+1) share draw j with opposite signs.

Fitness is COST (lower is better). Non-finite fitness (deadlocked
rollouts score +inf) is ranked strictly worst.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import prng


class StrategyState(NamedTuple):
    """Search state: per-dim mean/scale in the free search space."""

    mean: np.ndarray   # (D,) float32
    sigma: np.ndarray  # (D,) float32
    gen: int           # generation counter — drives the draw key chain


@runtime_checkable
class Strategy(Protocol):
    """ask/tell protocol over a D-dim continuous search space."""

    population: int

    def init(self, mean: np.ndarray, sigma: np.ndarray) -> StrategyState:
        ...

    def ask(self, state: StrategyState) -> np.ndarray:
        """Return (population, D) candidate points for ``state.gen``."""
        ...

    def tell(self, state: StrategyState, candidates: np.ndarray,
             fitness: np.ndarray) -> StrategyState:
        """Consume per-candidate costs; return the next-generation state."""
        ...


def _as_state(mean: np.ndarray, sigma: np.ndarray, gen: int) -> StrategyState:
    mean = np.asarray(mean, np.float32).reshape(-1)
    sigma = np.asarray(sigma, np.float32).reshape(-1)
    if mean.shape != sigma.shape:
        raise ValueError(f"mean/sigma shape mismatch: {mean.shape} vs {sigma.shape}")
    return StrategyState(mean=mean, sigma=sigma, gen=int(gen))


def draw_eps(seed: int, gen: int, population: int, dim: int,
             antithetic: bool) -> np.ndarray:
    """(population, dim) standard-normal perturbations, prefix-stable.

    Candidate i's draw is keyed on fold_in(fold_in(key(seed), gen), j)
    where j = i//2 under antithetic pairing (odd i negates), j = i
    otherwise — so growing the population appends rows without
    changing existing ones.
    """
    base = prng.fold_in(prng.PRNGKey(seed), gen)
    idx = np.arange(population)
    j = idx // 2 if antithetic else idx
    sign = np.where(antithetic & (idx % 2 == 1), -1.0, 1.0)
    n_draws = (population + 1) // 2 if antithetic else population
    keys = prng.fold_in(base[None, :], torch.arange(n_draws))
    eps = prng.normal(keys, (dim,)).numpy()              # (n_draws, dim)
    return (sign[:, None] * eps[j]).astype(np.float32)


def rank_fitness(fitness: np.ndarray) -> np.ndarray:
    """Ordinal ranks of costs, 0 = best; non-finite ranked worst.

    Ties (and all-inf populations) break by candidate index, so the
    result is deterministic for any input.
    """
    f = np.asarray(fitness, np.float64).copy()
    bad = ~np.isfinite(f)
    f[bad] = np.inf
    order = np.argsort(f, kind="stable")
    ranks = np.empty(len(f), np.int64)
    ranks[order] = np.arange(len(f))
    return ranks


def centered_rank_utilities(fitness: np.ndarray) -> np.ndarray:
    """Rank-shaped utilities in [-0.5, 0.5]; best candidate gets +0.5.

    Invariant to monotone transforms of the costs, which makes ES steps
    meaningful even for pool-relative rank-based objectives.
    """
    n = len(fitness)
    if n <= 1:
        return np.zeros(n, np.float32)
    ranks = rank_fitness(fitness)
    return ((n - 1 - ranks) / (n - 1) - 0.5).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ES:
    """OpenAI-style evolution strategy (rank-shaped, antithetic pairs).

    ask: candidates = mean + sigma * eps with eps from ``draw_eps``.
    tell: mean += lr * sigma * (2/N) Σ u_i eps_i  (u = centered ranks),
    then sigma *= sigma_decay. Minimizes cost.
    """

    population: int = 16
    seed: int = 0
    lr: float = 1.0
    antithetic: bool = True
    sigma_decay: float = 1.0

    def init(self, mean: np.ndarray, sigma: np.ndarray) -> StrategyState:
        return _as_state(mean, sigma, 0)

    def ask(self, state: StrategyState) -> np.ndarray:
        eps = draw_eps(self.seed, state.gen, self.population,
                       state.mean.shape[0], self.antithetic)
        return (state.mean[None, :] + state.sigma[None, :] * eps).astype(np.float32)

    def tell(self, state: StrategyState, candidates: np.ndarray,
             fitness: np.ndarray) -> StrategyState:
        candidates = np.asarray(candidates, np.float32)
        if candidates.shape[0] != self.population:
            raise ValueError(
                f"tell() got {candidates.shape[0]} candidates, expected {self.population}")
        u = centered_rank_utilities(fitness)
        sigma = np.maximum(state.sigma, 1e-8)
        eps = (candidates - state.mean[None, :]) / sigma[None, :]
        grad = (2.0 / self.population) * (u[:, None] * eps).sum(axis=0)
        mean = state.mean + np.float32(self.lr) * state.sigma * grad.astype(np.float32)
        new_sigma = (state.sigma * np.float32(self.sigma_decay)).astype(np.float32)
        return _as_state(mean, new_sigma, state.gen + 1)


@dataclasses.dataclass(frozen=True)
class CEM:
    """Cross-entropy method: refit mean/sigma on the elite fraction.

    Pure selection — depends only on the fitness ordering, so it is the
    safe default for rank-based goals and rugged landscapes.
    """

    population: int = 16
    seed: int = 0
    elite_frac: float = 0.25
    antithetic: bool = True
    sigma_floor: float = 1e-3
    momentum: float = 1.0  # 1.0 = full refit toward the elites

    def elite_count(self) -> int:
        return max(1, min(self.population, int(round(self.elite_frac * self.population))))

    def init(self, mean: np.ndarray, sigma: np.ndarray) -> StrategyState:
        return _as_state(mean, sigma, 0)

    def ask(self, state: StrategyState) -> np.ndarray:
        eps = draw_eps(self.seed, state.gen, self.population,
                       state.mean.shape[0], self.antithetic)
        return (state.mean[None, :] + state.sigma[None, :] * eps).astype(np.float32)

    def tell(self, state: StrategyState, candidates: np.ndarray,
             fitness: np.ndarray) -> StrategyState:
        candidates = np.asarray(candidates, np.float32)
        if candidates.shape[0] != self.population:
            raise ValueError(
                f"tell() got {candidates.shape[0]} candidates, expected {self.population}")
        ranks = rank_fitness(fitness)
        elites = candidates[ranks < self.elite_count()]
        m = np.float32(self.momentum)
        new_mean = elites.mean(axis=0).astype(np.float32)
        new_sigma = np.maximum(elites.std(axis=0), np.float32(self.sigma_floor)).astype(np.float32)
        mean = ((1.0 - m) * state.mean + m * new_mean).astype(np.float32)
        sigma = ((1.0 - m) * state.sigma + m * new_sigma).astype(np.float32)
        return _as_state(mean, sigma, state.gen + 1)
