"""Shared model building blocks + the parameter-table convention.

Port of ``repro/models/common.py``.  Every architecture describes its
parameters declaratively via a *param table*: ``name -> (shape,
logical_axes)``, with the reference's names, shapes and axes (layer
stacks add a leading ``"layers"`` axis).  The port keeps the table for
sizing and naming; the parameters themselves live in ``nn.Module``s
(``TableModule``), one per layer, whose ``named_parameters()`` are the
table's per-layer names (``attn.wq``, ``tm.ln_x.scale``, ...).

``init_params`` follows the reference's rules with a ``torch.Generator``
(ones for norm gains, zeros for biases, normal with std
``min(0.02, 1/sqrt(fan_in))`` for the rest).  The values differ from
JAX's threefry draws; parity tests carry JAX's values across with
``repro_torch.convert.params_from_numpy``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

ParamTable = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]
Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# Param-table helpers
# ----------------------------------------------------------------------

def stack_table(table: ParamTable, n_layers: int) -> ParamTable:
    """Add a leading scanned-layers axis to every entry."""
    return {k: ((n_layers,) + shape, ("layers",) + axes)
            for k, (shape, axes) in table.items()}


def prefix_table(prefix: str, table: ParamTable) -> ParamTable:
    return {f"{prefix}.{k}": v for k, v in table.items()}


def merge_tables(*tables: ParamTable) -> ParamTable:
    out: ParamTable = {}
    for t in tables:
        dup = set(out) & set(t)
        if dup:
            raise ValueError(f"duplicate param names: {dup}")
        out.update(t)
    return out


def count_params(table: ParamTable) -> int:
    total = 0
    for shape, _ in table.values():
        n = 1
        for d in shape:
            n *= int(d)
        total += n
    return total


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------

def init_rule(name: str, shape: Tuple[int, ...],
              scale: float = 0.02) -> Tuple[str, float]:
    """The reference's rule for one table entry: ``("ones", 0)``,
    ``("zeros", 0)`` or ``("normal", std)``; ``shape`` is the table's
    (stacked) shape, whose second-to-last axis is the fan-in."""
    if name.endswith(("norm.scale", "ln.scale")):
        return "ones", 0.0
    if name.endswith((".bias", "norm.bias", ".decay_bias")):
        return "zeros", 0.0
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return "normal", min(scale, 1.0 / math.sqrt(max(fan_in, 1)))


def init_tensor_(t: torch.Tensor, rule: Tuple[str, float],
                 generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place by ``rule`` (from ``init_rule``), drawing in
    float32 on ``t``'s device and rounding once to its dtype."""
    kind, std = rule
    if kind == "ones":
        return t.fill_(1.0)
    if kind == "zeros":
        return t.zero_()
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    draw.normal_(0.0, std, generator=generator)
    return t.copy_(draw)


def init_params(table: ParamTable, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None,
                scale: float = 0.02) -> Params:
    """A flat ``{name: tensor}`` dict of the table's (stacked) shapes,
    drawn in sorted name order from ``generator`` (which must live on
    ``device``)."""
    device = generator.device if device is None else device
    params: Params = {}
    for name, (shape, _) in sorted(table.items()):
        t = torch.empty(shape, dtype=dtype, device=device)
        params[name] = init_tensor_(t, init_rule(name, shape, scale),
                                    generator)
    return params


class TableModule(nn.Module):
    """Parameters named by a table's dotted names, as nested submodules:
    ``{"attn.wq": shape}`` becomes ``self.attn.wq``, and
    ``named_parameters()`` yields ``"attn.wq"`` again.  Parameters are
    allocated uninitialized and need no gradient (serving only)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]],
                 dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()
        for name, shape in shapes.items():
            owner: nn.Module = self
            *path, leaf = name.split(".")
            for part in path:
                child = getattr(owner, part, None)
                if child is None:
                    child = nn.Module()
                    owner.add_module(part, child)
                owner = child
            owner.register_parameter(leaf, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    def params(self) -> Params:
        """``{dotted name: tensor}``, the table's names."""
        return dict(self.named_parameters())


class TableModel(nn.Module):
    """A whole model's parameters in per-layer ``TableModule``s.  A
    subclass lists them by the reference's names in ``table_entries``
    (what ``convert`` carries across) and keeps one in ``self.top``."""

    top: TableModule

    def table_entries(self) -> Iterator[Tuple[str, Tuple[int, ...],
                                              List[torch.Tensor]]]:
        """``(reference name, reference shape, per-layer tensors)`` for
        every entry of the reference's table: a stacked entry lists one
        tensor per layer (the slices of its leading axis), any other
        entry one."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.top.embed.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     scale: float = 0.02) -> "TableModel":
        """The reference's init rules (``init_rule``, with the fan-in of
        the reference's stacked shape), drawn from ``generator`` (on this
        model's device) in sorted name order."""
        for name, shape, tensors in sorted(self.table_entries(),
                                           key=lambda e: e[0]):
            rule = init_rule(name, shape, scale)
            for t in tensors:
                init_tensor_(t, rule, generator)
        return self


# ----------------------------------------------------------------------
# Primitive layers (pure functions on tensors)
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalize in float32, cast back to ``x``'s dtype, then scale (the
    reference's order of casts)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D) or (..., S, D); positions
    (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs            # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == ang.ndim + 1:        # (..., S, H, D): broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.einsum``
    promotes (bf16 activations against f32 weights compute in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def embed(tokens: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def unembed(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Logits via tied or untied unembedding: (..., d) @ (V, d)^T."""
    return matmul(x, embedding.t())
