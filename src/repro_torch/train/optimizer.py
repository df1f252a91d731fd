"""Optimizer: AdamW, a warmup + cosine schedule and global-norm clipping.

Port of ``repro/train/optimizer.py`` as plain functions on flat
``{name: tensor}`` dicts, with the reference's arithmetic (not
``torch.optim.AdamW``'s):

* grads are clipped by their global norm first;
* ``upd = (mu / c1) / (sqrt(nu / c2) + eps)`` with ``c1 = 1 - b1**t`` and
  ``c2 = 1 - b2**t`` computed in f32, the weight decay added to ``upd``
  before it is scaled by ``lr``;
* parameters whose name ends in one of ``_NO_DECAY_SUFFIXES`` take no
  decay;
* moments in f32, parameters in their storage dtype (rounded once).

``adamw_update`` updates the parameters and moments in place (the
reference donates them to its jitted step) and returns them.  Scalars
(``lr``, the norm, the corrections) stay on the parameters' device, so
a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Params            # first moment (f32)
    nu: Params            # second moment (f32)
    count: torch.Tensor   # int32 step, 0-d


def init_opt_state(params: Params) -> OptState:
    """Zero f32 moments shaped like ``params``, count 0, on their
    device."""
    def zeros() -> Params:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(mu=zeros(), nu=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """f32 constant on ``like``'s device (filled there: no host copy)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` rounded once, on every device: CUDA turns a division by
    a Python number into a product with its reciprocal (an ulp off in
    places); a division by a tensor it keeps."""
    return torch.div(x, _f32(v, x))


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``end_lr_frac * peak``; f32 0-d
    on ``step``'s device."""
    step = step.float()
    warm = div(cfg.peak_lr * step, max(cfg.warmup_steps, 1))
    prog = torch.clamp(div(step - cfg.warmup_steps,
                           max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    floor = cfg.peak_lr * cfg.end_lr_frac
    cos = floor + (cfg.peak_lr - floor) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32; the tensors
    in sorted name order, as ``jax.tree.leaves`` orders a dict."""
    total = None
    for k in sorted(tree):
        sq = torch.sum(torch.square(tree[k].float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))`` in f32 (``torch.div``: a
    Python float over a tensor would be its reciprocal times the
    float)."""
    return torch.clamp(torch.div(_f32(max_norm, norm),
                                 torch.clamp(norm, min=1e-9)), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm


_NO_DECAY_SUFFIXES = (".bias", "norm.scale", "norm.bias", "ln.scale",
                      "ln.bias", ".mu", ".mu_x", ".mu_k", ".mu_r",
                      ".decay_base", ".bonus", ".lambda",
                      ".rgate_bias", ".igate_bias")


def _decays(name: str) -> bool:
    return not name.endswith(_NO_DECAY_SUFFIXES)


#: Elements updated at once: a tensor's update runs over slices of its
#: flat view, so its f32 temporaries stay bounded (an embedding of 1.2e9
#: elements would otherwise take 5 GB a temporary).
OPT_CHUNK = 1 << 26


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Params, grads: Params,
                 opt: OptState) -> Tuple[Params, OptState, Params]:
    """One AdamW step over the flat dict, in place.  ``grads`` are f32
    (the accumulation dtype); they are clipped by their global norm (the
    scale applied slice by slice, as the rest: every operation is
    elementwise, so slicing changes no value).  Returns (params, the new
    ``OptState``, {"lr", "grad_norm"})."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = opt.count + 1
    lr = lr_at(cfg, count)
    t = count.float()
    c1 = 1.0 - torch.pow(_f32(cfg.b1, t), t)
    c2 = 1.0 - torch.pow(_f32(cfg.b2, t), t)
    for name, p in params.items():
        decays = _decays(name)
        pf, gf = p.view(-1), grads[name].reshape(-1)
        mf, nf = opt.mu[name].view(-1), opt.nu[name].view(-1)
        for lo in range(0, pf.numel(), OPT_CHUNK):
            at = slice(lo, lo + OPT_CHUNK)
            g = gf[at].float() * scale
            mu = mf[at].mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu = nf[at].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            if decays:
                upd = upd + cfg.weight_decay * pf[at].float()
            pf[at] = pf[at].float() - lr * upd
    return (params, OptState(mu=opt.mu, nu=opt.nu, count=count),
            {"lr": lr, "grad_norm": gnorm})
