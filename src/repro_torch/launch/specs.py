"""Abstract input specs for the dry run: meta tensors in place of the
reference's ``ShapeDtypeStruct``s -- every model input's shape and dtype,
nothing allocated.  Port of ``repro/launch/specs.py``.

``cell_inputs(arch, shape)`` returns everything ``dryrun`` needs to run
the right step function for that cell:

  train cells   -> (abstract TrainState, abstract batch)
  prefill cells -> (abstract params, abstract batch)
  decode cells  -> (abstract params, abstract caches, tokens, index)

Token ids (``tokens``, ``labels``) are int64 here, where the reference's
are int32: the port indexes with them (``train_step.batch_on`` casts any
batch's ids to int64).  Every other leaf has the reference's dtype.  The
decode ``index`` is a 0-d int32 tensor, as the reference's; the port's
``decode_step`` takes a host int, which ``dryrun.run_cell`` supplies.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs import ShapeCell, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.common import abstract_params
from repro_torch.train.train_step import abstract_train_state

#: The port's token-id dtype (the reference's is int32).
TOKEN_DTYPE = torch.int64


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class CellSpec(NamedTuple):
    kind: str                 # "train" | "prefill" | "decode"
    cfg: ModelConfig
    args: tuple               # abstract positional args for the step fn


def _front_end(cfg: ModelConfig, batch: int, seq: int
               ) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "vlm":
        out["patches"] = sds((batch, cfg.n_patches, cfg.d_model),
                             torch.bfloat16)
    if cfg.family == "encdec":
        s_enc = max(int(seq * cfg.encoder_seq_ratio), 1)
        out["frames"] = sds((batch, s_enc, cfg.d_model), torch.bfloat16)
    return out


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, torch.Tensor]:
    return {"tokens": sds((batch, seq), TOKEN_DTYPE),
            "labels": sds((batch, seq), TOKEN_DTYPE),
            "mask": sds((batch, seq), torch.int32),
            **_front_end(cfg, batch, seq)}


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int
                        ) -> Dict[str, torch.Tensor]:
    return {"tokens": sds((batch, seq), TOKEN_DTYPE),
            **_front_end(cfg, batch, seq)}


def abstract_caches(cfg: ModelConfig, batch: int, seq: int) -> Any:
    """``api.init_caches``'s tree on meta (no allocation)."""
    return api.init_caches(cfg, batch, seq, device="meta")


def cell_inputs(arch: str, cell: ShapeCell,
                cfg: Optional[ModelConfig] = None) -> CellSpec:
    cfg = cfg or get_config(arch)
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        state = abstract_train_state(cfg)
        batch = train_batch_specs(cfg, b, s)
        return CellSpec("train", cfg, (state, batch))
    if cell.kind == "prefill":
        params = abstract_params(api.param_table(cfg))
        batch = prefill_batch_specs(cfg, b, s)
        return CellSpec("prefill", cfg, (params, batch))
    if cell.kind == "decode":
        params = abstract_params(api.param_table(cfg))
        caches = abstract_caches(cfg, b, s)
        tokens = sds((b, 1), TOKEN_DTYPE)
        index = sds((), torch.int32)
        return CellSpec("decode", cfg, (params, caches, tokens, index))
    raise ValueError(cell.kind)


def input_specs(arch: str, shape_name: str = "train_4k") -> Dict[str, Any]:
    """Flat convenience view (README snippets / quick inspection)."""
    from repro_torch.configs import SHAPES
    spec = cell_inputs(arch, SHAPES[shape_name])
    if spec.kind == "train":
        return {"state": spec.args[0], "batch": spec.args[1]}
    if spec.kind == "prefill":
        return {"params": spec.args[0], "batch": spec.args[1]}
    return {"params": spec.args[0], "caches": spec.args[1],
            "tokens": spec.args[2], "index": spec.args[3]}
