"""On-device policy learning (DESIGN.md §13) — port of ``repro.learn``.

Population-based training (ES / CEM) of parametric ``PolicySpec`` θ:
every generation — N candidate θ × S training scenarios (× optional
fan members) — is evaluated as one batched replay grid with the
population riding the fork axis, scored by any ``core.objective``
goal, and the trained θ deploys live through the ``trained:<ckpt>``
pool-grammar entry.
"""
from repro_torch.learn.strategy import CEM, ES, Strategy, StrategyState
from repro_torch.learn.evolution import ParamSpace, family_space, static_seeds
from repro_torch.learn.trainer import (TrainConfig, TrainResult,
                                       load_trained_pool, train)

__all__ = [
    "Strategy", "StrategyState", "ES", "CEM",
    "ParamSpace", "family_space", "static_seeds",
    "TrainConfig", "TrainResult", "train", "load_trained_pool",
]
