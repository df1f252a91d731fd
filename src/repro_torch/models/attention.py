"""Attention in plain PyTorch: port of ``repro/models/attention.py``.

``full_attention`` is *triangle-blocked* like the reference: the query
axis is split into blocks, and each block attends only to its key prefix
(causal), a sliding window (local), or the full sequence
(bidirectional), with the softmax of each block in float32.  It is the
plain version of K4, the flash-attention CUDA kernel
(``repro_torch.kernels.flash_attention``), which computes the same
function with an online softmax; the chip check holds the two together.

``decode_attention`` and ``update_cache`` are the one-token decode step
against a preallocated KV cache (plain torch, as in the reference, where
they are XLA and not Pallas).  ``update_cache`` writes in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*G, S, D): each kv head repeated for its
    ``group`` query heads (query head h reads kv head h // group)."""
    if group == 1:
        return k
    return k.repeat_interleave(group, dim=1)


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float
                  ) -> torch.Tensor:
    """q: (B, H, Bq, D); k/v: (B, H, Ctx, D); mask broadcastable to
    (B, H, Bq, Ctx).  Scores and softmax in f32; the probabilities are
    cast to v's dtype before P·V, as the reference does."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype) @ v


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   local_window: int = 0,
                   q_block: int = 512,
                   q_offset: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Triangle-blocked multi-(grouped-)head attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D) in
    v's dtype.  ``q_offset``: global position of q[..., 0, :].
    ``local_window`` > 0 limits attention to the last W positions;
    implies causal.
    """
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_block = min(q_block, sq)
    n_blocks = (sq + q_block - 1) // q_block
    k = _expand_kv(k, hq // hkv)
    v = _expand_kv(v, hq // hkv)

    outs = []
    for i in range(n_blocks):
        lo = i * q_block
        hi = min(lo + q_block, sq)
        if not (causal or local_window):
            outs.append(_attend_block(q[:, :, lo:hi], k, v, None, scale))
            continue
        q_pos_hi = q_offset + hi          # exclusive global end of block
        k_lo = (max(0, q_pos_hi - local_window - (hi - lo))
                if local_window > 0 else 0)
        k_hi = min(q_pos_hi, sk)
        q_pos = (q_offset + torch.arange(lo, hi, device=q.device))[:, None]
        k_pos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if local_window > 0:
            mask &= k_pos > (q_pos - local_window)
        outs.append(_attend_block(q[:, :, lo:hi], k[:, :, k_lo:k_hi],
                                  v[:, :, k_lo:k_hi], mask, scale))
    return torch.cat(outs, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     kv_valid: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode: q (B, Hq, 1, D) vs cache (B, Hkv, S, D).

    ``kv_valid`` (B, S) masks unwritten/ring-buffer slots.  Queries are
    grouped as (B, Hkv, G, 1, D) against the raw cache, so repeated KV
    heads are never materialized."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, hq // hkv, d)                  # (B, Hkv, G, D)
    scores = (qg.float() @ k_cache.float().transpose(-1, -2)) * scale
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v_cache.dtype) @ v_cache               # (B, Hkv, G, D)
    return out.reshape(b, hq, 1, v_cache.shape[-1])


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step (B, Hkv, 1, D) into the caches at sequence
    position ``index``, in place; returns the caches.  Like the
    reference's ``dynamic_update_slice``, an index past the end is
    clamped to the last position."""
    idx = min(max(int(index), 0), k_cache.shape[2] - 1)
    k_cache[:, :, idx:idx + 1] = k_new.to(k_cache.dtype)
    v_cache[:, :, idx:idx + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
