"""Gradient compression with error feedback: port of
``repro/train/compression.py``.

int8 block quantization of f32 gradients with the quantization error
carried to the next step (EF-SGD):

    acc   = grad + error
    q     = quantize(acc)          (int8 + a per-block f32 scale)
    error = acc - dequantize(q)

On one GPU no gradient crosses a wire; the round trip is kept because
it changes what the optimizer sees, bit for bit as in the reference:
every operation here is exact in f32 (max, divide, round half to even,
clip), so the port's values are the reference's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.nn import functional as F

from repro_torch.train.optimizer import div

BLOCK = 256  # quantization block (flat groups)


class Compressed(NamedTuple):
    q: torch.Tensor      # int8 payload, (n_blocks, BLOCK)
    scale: torch.Tensor  # f32 per-block scale, (n_blocks, 1)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def quantize(x: torch.Tensor) -> Compressed:
    """Symmetric int8 per-block quantization of an f32 tensor."""
    blocks, _ = _pad_to_block(x)
    scale = div(torch.amax(torch.abs(blocks), dim=-1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale.float())


def dequantize(c: Compressed, shape) -> torch.Tensor:
    flat = (c.q.float() * c.scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           errors: Dict[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor],
                                      torch.Tensor]:
    """(decompressed grads, new error buffers, mean abs quantization
    error over the tensors)."""
    out: Dict[str, torch.Tensor] = {}
    new_err: Dict[str, torch.Tensor] = {}
    tot_err = None
    for name, g in grads.items():
        acc = g.float() + errors[name]
        deq = dequantize(quantize(acc), g.shape)
        out[name] = deq
        new_err[name] = acc - deq
        e = torch.mean(torch.abs(new_err[name]))
        tot_err = e if tot_err is None else tot_err + e
    if tot_err is None:
        tot_err = torch.zeros((), dtype=torch.float32)
    return out, new_err, div(tot_err, max(len(grads), 1))


def init_error_buffers(params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def abstract_error_buffers(params: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """``init_error_buffers``'s shapes as meta tensors (the dry run's)."""
    return {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in params.items()}
