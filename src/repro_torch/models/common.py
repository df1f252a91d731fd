"""Shared model building blocks + the parameter-table convention.

Port of ``repro/models/common.py``.  Every architecture describes its
parameters declaratively via a *param table*: ``name -> (shape,
logical_axes)``, with the reference's names, shapes and axes (layer
stacks add a leading ``"layers"`` axis).  The port keeps the table for
sizing and naming; the parameters themselves live in ``nn.Module``s
(``TableModule``), one per layer, whose ``named_parameters()`` are the
table's per-layer names (``attn.wq``, ``tm.ln_x.scale``, ...).

``init_params`` and ``TableModel.init_weights`` draw the reference's
``init_params(jax.random.PRNGKey(seed), table)`` bit for bit (ones for
norm gains, zeros for biases, ``std * normal`` with std
``min(0.02, 1/sqrt(fan_in))`` for the rest), on the port's copy of
``jax.random`` (``core/prng.py``), on any device.

``chunked_softmax_xent`` is the reference's training loss over the
vocabulary, a sequence chunk of f32 logits at a time.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device

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


#: Elements drawn at once: a draw's counters and f32/f64 temporaries
#: take tens of bytes an element, so large entries (olmoe's experts hold
#: 2.1e9) are drawn in slices of the flat iota, with the same bits.
INIT_CHUNK = 1 << 24

KeyLike = Union[int, torch.Tensor]


def as_key(key: KeyLike, device: torch.device) -> torch.Tensor:
    """A ``prng`` key on ``device``: an int seed becomes
    ``PRNGKey(seed)``, as ``jax.random.PRNGKey`` would."""
    if isinstance(key, torch.Tensor):
        return key.to(device)
    return prng.PRNGKey(key, device)


def draw_(tensors: List[torch.Tensor], shape: Tuple[int, ...],
          rule: Tuple[str, float], key: torch.Tensor) -> None:
    """Fill ``tensors``, the slices of one table entry of (stacked)
    ``shape`` along its leading axis (or one tensor of the whole shape),
    in place by ``rule`` (from ``init_rule``).  A normal entry is the
    reference's ``std * jax.random.normal(key, shape)``: each f32 draw
    is multiplied by the f32 std and rounded once to the dtype, slice by
    slice of the flat iota, so no more than ``INIT_CHUNK`` elements are
    drawn at a time."""
    kind, std = rule
    if kind != "normal":
        for t in tensors:
            t.fill_(1.0 if kind == "ones" else 0.0)
        return
    std32 = torch.full((), float(np.float32(std)), dtype=torch.float32,
                       device=key.device)
    offset = 0
    for t in tensors:
        flat = t.view(-1)
        for lo in range(0, flat.numel(), INIT_CHUNK):
            n = min(INIT_CHUNK, flat.numel() - lo)
            flat[lo:lo + n] = prng.normal(key, (n,), offset + lo) * std32
        offset += flat.numel()
    assert offset == math.prod(shape), (offset, shape)


def init_params(key: KeyLike, table: ParamTable,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = "cuda",
                scale: float = 0.02) -> Params:
    """The reference's ``init_params(key, table, dtype, scale)``, bit for
    bit: a flat ``{name: tensor}`` dict of the table's (stacked) shapes
    on ``device``.  ``key`` is a ``prng`` key or an int seed (its
    ``PRNGKey``); the table's entries, in sorted name order, take one
    key each of ``split(key, len(table))``, ones/zeros entries too."""
    dev = resolve_device(device)
    entries = sorted(table.items())
    keys = prng.split(as_key(key, dev), max(len(entries), 1))
    params: Params = {}
    for (name, (shape, _)), k in zip(entries, keys):
        t = torch.empty(shape, dtype=dtype, device=dev)
        draw_([t], shape, init_rule(name, shape, scale), k)
        params[name] = t
    return params


class TableModule(nn.Module):
    """Parameters named by a table's dotted names, as nested submodules:
    ``{"attn.wq": shape}`` becomes ``self.attn.wq``, and
    ``named_parameters()`` yields ``"attn.wq"`` again.  Parameters are
    allocated uninitialized and registered without a gradient (serving
    runs under ``torch.inference_mode``); ``requires_grad_(True)`` makes
    them trainable, and ``lm.train_loss`` then differentiates them."""

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
    def init_weights(self, key: KeyLike = 0,
                     scale: float = 0.02) -> "TableModel":
        """The reference's ``init_params(key, table)`` in this model's
        per-layer tensors, bit for bit: the sorted table's entries take
        one key each of ``split(key, len(table))``, and a stacked entry
        is drawn over its whole stacked shape and sliced into the
        layers.  ``key``: a ``prng`` key or an int seed."""
        entries = sorted(self.table_entries(), key=lambda e: e[0])
        keys = prng.split(as_key(key, self.device), max(len(entries), 1))
        for (name, shape, tensors), k in zip(entries, keys):
            draw_(tensors, shape, init_rule(name, shape, scale), k)
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


def chunked_softmax_xent(x: torch.Tensor, labels: torch.Tensor,
                         unembed_w: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 1024) -> torch.Tensor:
    """The reference's cross-entropy over the vocabulary: f32 logits a
    sequence chunk of ``chunk`` positions at a time (the reference scans
    the chunks), then the remainder, summed in that order, over the
    mask's sum (at least 1).  ``x``: (B, S, d); ``labels``/``mask``:
    (B, S)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    n_chunks = s // chunk
    mask = mask.to(device=x.device, dtype=torch.float32)
    labels = labels.to(device=x.device, dtype=torch.int64)

    def chunk_loss(lo: int, hi: int) -> torch.Tensor:
        logits = unembed(x[:, lo:hi], unembed_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, lo:hi, None])[..., 0]
        return torch.sum((lse - gold) * mask[:, lo:hi])

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        total = total + chunk_loss(c * chunk, (c + 1) * chunk)
    if s - n_chunks * chunk:
        total = total + chunk_loss(n_chunks * chunk, s)
    return total / torch.clamp_min(mask.sum(), 1.0)
