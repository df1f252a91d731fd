"""The training step: microbatched gradient accumulation + AdamW.

Port of ``repro/train/train_step.py`` for one GPU.  ``TrainState``
holds the reference's flat parameter dict (its names, its stacked
shapes: ``seg0.attn.wq`` is (L, d, H, D)), the optimizer state and the
error-feedback buffers, so a checkpoint of either package restores in
the other with the same leaf names (``params/…``, ``opt/mu/…``,
``opt/nu/…``, ``opt/count``, ``ef/…``; an ``ef`` of None holds none).

``make_train_step(cfg, opt_cfg)`` returns ``step_fn(state, batch) ->
(state, metrics)``, the reference's step: the batch split into
``accum_steps`` microbatches, each one's loss differentiated by
autograd (``api.train_loss`` runs the plain paths), the gradients cast
to f32 and summed, divided by the count, metrics averaged over
microbatches, then the optional int8 compression with error feedback,
then ``adamw_update`` in place (the reference donates the state).

The reference's ``state_shardings``, ``batch_shardings`` and
``jit_train_step`` place the state and the batch on a mesh; on one GPU
there is nothing to place (ROADMAP A11.7).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.common import KeyLike, init_params
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, div, init_opt_state)

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Params
    opt: OptState
    ef: Optional[Params]   # error-feedback buffers (compression only)


def init_train_state(key: KeyLike, cfg: ModelConfig, *,
                     compress: bool = False,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = "cuda") -> TrainState:
    """The reference's ``init_train_state(key, cfg)``: the parameters of
    ``init_params(key, param_table(cfg))`` (bit for bit; ``key`` a
    ``prng`` key or an int seed), trainable, on ``device``; zero f32
    moments; zero error buffers when ``compress``."""
    params = init_params(key, api.param_table(cfg), dtype, device)
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(
        params=params,
        opt=init_opt_state(params),
        ef=compression.init_error_buffers(params) if compress else None)


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int
                        ) -> Dict[str, torch.Tensor]:
    def split(x):
        b = x.shape[0]
        assert b % accum == 0, f"batch {b} not divisible by accum {accum}"
        return x.reshape(accum, b // accum, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def batch_on(batch: Dict[str, Any], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``: token ids as int64
    (they index), everything else in its own dtype."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(cfg: ModelConfig,
                    opt_cfg: OptimizerConfig = OptimizerConfig(), *,
                    compress: bool = False,
                    accum_steps: Optional[int] = None,
                    device: DeviceLike = "cuda"):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch``
    holds host arrays or tensors, moved to ``device`` (the state's).
    ``metrics``: the loss's (``xent``, the aux terms, ``loss``), ``lr``,
    ``grad_norm`` and, with ``compress``, ``compression_err``; f32 0-d
    tensors on the device."""
    accum = accum_steps if accum_steps is not None else cfg.accum_steps
    dev = resolve_device(device)

    def grad_fn(params: Params, mb: Dict[str, torch.Tensor]):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, metrics = api.train_loss(cfg, leaves, mb)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)

    def step_fn(state: TrainState, batch: Dict[str, Any]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = batch_on(batch, dev)
        if accum > 1:
            mbs = _split_microbatches(batch, accum)
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in state.params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            stack = []
            for i in range(accum):
                (loss, metrics), grads = grad_fn(
                    state.params, {k: v[i] for k, v in mbs.items()})
                for k, g in grads.items():
                    gsum[k] += g.float()
                lsum = lsum + loss
                stack.append(metrics)
            grads = {k: div(g, accum) for k, g in gsum.items()}
            loss = div(lsum, accum)
            metrics = {k: torch.mean(torch.stack([m[k] for m in stack]))
                       for k in stack[0]}
        else:
            (loss, metrics), grads = grad_fn(state.params, batch)
            for k in list(grads):       # each bf16 gradient freed in turn
                grads[k] = grads[k].float()

        ef = state.ef
        metrics = dict(metrics)
        if compress:
            grads, ef, qerr = compression.compress_with_feedback(grads, ef)
            metrics["compression_err"] = qerr

        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, ef), metrics

    return step_fn
