"""Model facade: family-dispatched entry points with one signature.

Port of ``repro/models/api.py``.  The serving engine and the train step
talk to models through these functions.  ``encdec`` (Whisper) has its own
implementation (``models/encdec.py``); every other family shares
``lm``.  ``backend`` is "cuda" (the hand-written kernels, on CUDA
tensors) or "reference" (their plain versions, for checks).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.common import ParamTable

BACKENDS = ("cuda", "reference")

Model = Union[lm.LM, encdec.EncDec]
Caches = Dict[str, Any]


def _impl(cfg: ModelConfig, backend: str = "cuda"):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")
    return encdec if cfg.family == "encdec" else lm


def param_table(cfg: ModelConfig) -> ParamTable:
    return _impl(cfg).param_table(cfg)


def model_class(cfg: ModelConfig):
    """``EncDec`` for the encdec family, ``LM`` for the others."""
    return _impl(cfg).Model


def init_model(cfg: ModelConfig, seed: Union[int, torch.Tensor] = 0,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Model:
    """A model holding the reference's ``init_params(PRNGKey(seed),
    param_table(cfg))`` bit for bit, drawn on ``device``.  ``seed``: an
    int or a ``core.prng`` key."""
    dev = resolve_device(device)
    return model_class(cfg)(cfg, dtype, dev).init_weights(seed)


def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one batch, differentiable: ``params`` is
    a model or the reference's flat dict (``train.TrainState.params``).
    Runs the plain paths: no kernel has a backward."""
    return _impl(cfg).train_loss(cfg, params, batch)


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: Model, batch: Dict[str, Any],
            backend: str = "cuda") -> Tuple[torch.Tensor, Caches]:
    """Builds no autograd graph, whatever the parameters require.
    ``model``: a model or the reference's flat dict (``init_params``,
    ``abstract_params``)."""
    return _impl(cfg, backend).prefill(cfg, model, batch, backend)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, model: Model, caches: Caches,
                batch: Dict[str, Any], backend: str = "cuda"
                ) -> Tuple[torch.Tensor, Caches]:
    """Builds no autograd graph; writes ``caches`` in place."""
    return _impl(cfg, backend).decode_step(cfg, model, caches, batch,
                                           backend)


def init_caches(cfg: ModelConfig, batch: int, seq: int,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = "cuda") -> Caches:
    """Zeroed per-layer caches, bf16 by default whatever the parameters'
    dtype (the recurrent ``wkv`` state is always f32)."""
    return _impl(cfg).init_caches(cfg, batch, seq, dtype or torch.bfloat16,
                                  resolve_device(device))
