"""Model facade: family-dispatched entry points with one signature.

Port of ``repro/models/api.py`` for serving.  The serving engine talks to
models through these functions.  ``encdec`` (Whisper) has its own
implementation in the reference and is not ported yet (ROADMAP A11);
every ported family shares ``lm``.  ``backend`` is "cuda" (the
hand-written kernels, on CUDA tensors) or "reference" (their plain
versions, for checks).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ParamTable

BACKENDS = ("cuda", "reference")


def _check(cfg: ModelConfig, backend: str = "cuda") -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: family 'encdec' is not ported to repro_torch yet "
            f"(ROADMAP A11)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")


def param_table(cfg: ModelConfig) -> ParamTable:
    _check(cfg)
    return lm.lm_table(cfg)


def init_model(cfg: ModelConfig, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> lm.LM:
    """A model with random weights drawn on ``device`` from ``seed``."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.LM(cfg, dtype, dev).init_weights(gen)


def prefill(cfg: ModelConfig, model: lm.LM, batch: Dict[str, Any],
            backend: str = "cuda") -> Tuple[torch.Tensor, lm.Caches]:
    _check(cfg, backend)
    return lm.prefill(cfg, model, batch, backend)


def decode_step(cfg: ModelConfig, model: lm.LM, caches: lm.Caches,
                batch: Dict[str, Any], backend: str = "cuda"
                ) -> Tuple[torch.Tensor, lm.Caches]:
    _check(cfg, backend)
    return lm.decode_step(cfg, model, caches, batch, backend)


def init_caches(cfg: ModelConfig, batch: int, seq: int,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = "cuda") -> lm.Caches:
    """Zeroed per-layer caches, bf16 by default whatever the parameters'
    dtype (the recurrent ``wkv`` state is always f32)."""
    _check(cfg)
    return lm.init_caches(cfg, batch, seq, dtype or torch.bfloat16,
                          resolve_device(device))
