"""The roofline of a step on one H100: the card's rates, the reference's
``Roofline`` record and the useful-FLOP formulas, for the dry run
(``launch/dryrun.py``) and ``chip_smoke.py``'s bounds.  The op-by-op
counter they read is ``repro_torch/counting.py``.

``Roofline`` keeps the reference's fields; its terms divide by the H100
SXM's data-sheet rates below.  One card has no collectives, so those
terms are 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: NVIDIA H100 SXM (80 GB HBM3) data-sheet rates at its full 700 W power
#: limit: dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and non-tensor
#: 32-bit operations/s.  A card set to a lower limit runs slower.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
OP_RATE = 67e12

@dataclasses.dataclass
class Roofline:
    """The reference's record, per card.  ``flops`` and
    ``bytes_accessed`` are ``CostCounter``'s (trip counts included: the
    port's own eager traffic, more than the reference's post-fusion
    count).  One card has no collectives and no XLA: the collective
    fields and ``xla_*_raw`` stay 0."""
    flops: float
    bytes_accessed: float
    collective_bytes: float = 0.0
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    wire_bytes: float = 0.0
    xla_flops_raw: float = 0.0
    xla_bytes_raw: float = 0.0
    # derived (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0     # useful flops
    useful_ratio: float = 0.0    # model_flops / flops

    def finalize(self, model_flops: float = 0.0) -> "Roofline":
        self.t_compute = self.flops / PEAK_FLOPS_BF16
        self.t_memory = self.bytes_accessed / HBM_BW
        self.t_collective = 0.0      # one card: nothing crosses a link
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.model_flops = model_flops
        self.useful_ratio = (model_flops / self.flops) if self.flops else 0.0
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops_train(n_params: int, n_tokens: int,
                      active_frac: float = 1.0) -> float:
    """6*N*D (fwd+bwd) useful FLOPs; MoE passes active param fraction."""
    return 6.0 * n_params * active_frac * n_tokens


def model_flops_decode(n_params: int, n_tokens: int,
                       active_frac: float = 1.0) -> float:
    """2*N per generated token (fwd only)."""
    return 2.0 * n_params * active_frac * n_tokens
