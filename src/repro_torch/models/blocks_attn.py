"""Attention + MLP blocks (llama's dense block, and with a sliding
window RecurrentGemma's local block): port of
``repro/models/blocks_attn.py`` for one GPU (no sequence parallelism and
no sharding rules).

Block contract (shared by all block modules):

  table(cfg) -> ParamTable                       # declarative params
  apply(cfg, params, x, *, mode, cache, positions, index, backend)
      -> (y, new_cache, aux)

``mode`` is "prefill" or "decode".  ``positions`` is (B, S) global token
positions; ``index`` is decode's write position, a host int (the
reference's ``positions[0, 0]``: one uniform index for the batch).  In
decode the cache's tensors are written in place.  ``backend`` "cuda"
runs prefill attention, causal or windowed, through K4, the
flash-attention kernel, on CUDA tensors; "reference" runs its plain
version, ``full_attention``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.models import attention
from repro_torch.models.common import ParamTable, matmul, rms_norm, rope

Aux = Dict[str, torch.Tensor]
Cache = Optional[Dict[str, torch.Tensor]]


# ----------------------------------------------------------------------
# GQA/MQA attention sub-layer
# ----------------------------------------------------------------------

def attn_table(cfg: ModelConfig) -> ParamTable:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    t: ParamTable = {
        "attn.wq": ((d, cfg.n_heads, hd), ("d_model", "heads", "head_dim")),
        "attn.wk": ((d, cfg.n_kv_heads, hd),
                    ("d_model", "kv_heads", "head_dim")),
        "attn.wv": ((d, cfg.n_kv_heads, hd),
                    ("d_model", "kv_heads", "head_dim")),
        "attn.wo": ((cfg.n_heads, hd, d), ("heads", "head_dim", "d_model")),
        "attn_norm.scale": ((d,), (None,)),
    }
    if cfg.qkv_bias:
        t["attn.bq"] = ((cfg.n_heads, hd), ("heads", "head_dim"))
        t["attn.bk"] = ((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"))
        t["attn.bv"] = ((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"))
    return t


def init_attn_cache(cfg: ModelConfig, batch: int, seq: int,
                    dtype: torch.dtype, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    kv = max(cfg.n_kv_heads, 1)
    s = min(seq, cfg.local_window) if cfg.local_window else seq
    return {
        "k": torch.zeros((batch, kv, s, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, kv, s, hd), dtype=dtype, device=device),
    }


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, D) -> (B, S, H, D)."""
    b, s, _ = x.shape
    return matmul(x, w.reshape(w.shape[0], -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def attn_apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
               cache: Cache, positions: torch.Tensor,
               index: Optional[int] = None, local_window: int = 0,
               prefix: str = "attn", backend: str = "cuda"
               ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, S, d) -> (B, S, d).  RoPE + GQA + causal (or local)."""
    b, s, _ = x.shape
    q = project(x, params[f"{prefix}.wq"])
    k = project(x, params[f"{prefix}.wk"])
    v = project(x, params[f"{prefix}.wv"])
    if cfg.qkv_bias:
        q = q + params[f"{prefix}.bq"]
        k = k + params[f"{prefix}.bk"]
        v = v + params[f"{prefix}.bv"]

    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    # (B, S, H, D) -> (B, H, S, D), as views
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    if mode == "decode":
        assert cache is not None and index is not None
        n_pos = cache["k"].shape[2]
        kv_pos = torch.arange(n_pos, device=x.device)[None, :]
        if local_window:
            attention.update_cache(cache["k"], cache["v"], k, v,
                                   index % n_pos)
            # until the ring fills, only slots <= index have been written
            valid = (kv_pos <= index) | (index + 1 >= n_pos)
        else:
            attention.update_cache(cache["k"], cache["v"], k, v, index)
            valid = kv_pos <= index
        out = attention.decode_attention(q, cache["k"], cache["v"],
                                         kv_valid=valid.expand(b, n_pos))
        new_cache = {"k": cache["k"], "v": cache["v"]}
    else:
        if backend == "reference":
            out = attention.full_attention(
                q, k, v, causal=True, local_window=local_window,
                q_block=cfg.q_block)
        else:
            out = fa_kernel.flash_attention(q, k, v, causal=True,
                                            window=local_window)
        if local_window:
            # ring layout: slot = pos % window
            roll = s % local_window
            kc = torch.roll(k[:, :, -local_window:], roll, dims=2)
            vc = torch.roll(v[:, :, -local_window:], roll, dims=2)
        else:
            kc, vc = k, v
        new_cache = {"k": kc, "v": vc}

    out = out.transpose(1, 2).reshape(b, s, -1)          # (B, S, H*D)
    wo = params[f"{prefix}.wo"]
    return matmul(out, wo.reshape(-1, wo.shape[-1])), new_cache


# ----------------------------------------------------------------------
# SwiGLU MLP sub-layer
# ----------------------------------------------------------------------

def mlp_table(cfg: ModelConfig, d_ff: Optional[int] = None) -> ParamTable:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "mlp.w_gate": ((d, f), ("d_model", "d_ff")),
        "mlp.w_up": ((d, f), ("d_model", "d_ff")),
        "mlp.w_down": ((f, d), ("d_ff", "d_model")),
        "mlp_norm.scale": ((d,), (None,)),
    }


def mlp_apply(cfg: ModelConfig, params, x: torch.Tensor,
              prefix: str = "mlp") -> torch.Tensor:
    g = matmul(x, params[f"{prefix}.w_gate"])
    u = matmul(x, params[f"{prefix}.w_up"])
    return matmul(F.silu(g) * u, params[f"{prefix}.w_down"])


# ----------------------------------------------------------------------
# Full dense decoder block (pre-norm residual)
# ----------------------------------------------------------------------

def table(cfg: ModelConfig) -> ParamTable:
    return {**attn_table(cfg), **mlp_table(cfg)}


def apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
          cache: Cache, positions: torch.Tensor,
          index: Optional[int] = None, local_window: int = 0,
          backend: str = "cuda") -> Tuple[torch.Tensor, Cache, Aux]:
    h = rms_norm(x, params["attn_norm.scale"], cfg.norm_eps)
    a, new_cache = attn_apply(cfg, params, h, mode=mode, cache=cache,
                              positions=positions, index=index,
                              local_window=local_window, backend=backend)
    x = x + a
    h = rms_norm(x, params["mlp_norm.scale"], cfg.norm_eps)
    x = x + mlp_apply(cfg, params, h)
    return x, new_cache, {}


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return init_attn_cache(cfg, batch, seq, dtype, device)
