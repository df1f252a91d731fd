"""Recurrent blocks, the RWKV6 "Finch" half: port of
``repro/models/blocks_rnn.py`` (time mix, channel mix, the WKV6
recurrence).  The RG-LRU half and ``wkv_chunked`` are not ported yet
(ROADMAP A11).

``wkv_scan`` is the WKV6 recurrence over a sequence, one ``wkv_step``
per token: the plain version of K3, the CUDA kernel
(``repro_torch.kernels.wkv6``) that prefill runs on CUDA tensors.
Decode stays ``wkv_step`` in plain torch, as in the reference.

Block contract (shared with ``blocks_attn``):

  table(cfg) -> ParamTable
  apply(cfg, params, x, *, mode, cache, positions, index, backend)
      -> (y, new_cache, aux)

``mode`` is "prefill" or "decode" (the port serves; it does not train).
In decode the cache's tensors are updated in place.  ``backend`` is
"cuda" (the kernels, for CUDA tensors) or "reference" (plain versions).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.models.common import ParamTable, layer_norm, matmul

Aux = Dict[str, torch.Tensor]
Cache = Optional[Dict[str, torch.Tensor]]

LORA_MIX = 32        # token-shift ddlerp LoRA rank
LORA_DECAY = 64      # data-dependent decay LoRA rank


def rwkv_table(cfg: ModelConfig) -> ParamTable:
    d, f = cfg.d_model, cfg.d_ff
    n = cfg.rwkv_head_size
    h = d // n
    return {
        "ln1.scale": ((d,), (None,)), "ln1.bias": ((d,), (None,)),
        "ln2.scale": ((d,), (None,)), "ln2.bias": ((d,), (None,)),
        # time-mix: data-dependent token-shift interpolation (ddlerp)
        "tm.mu_x": ((d,), (None,)),
        "tm.mu": ((5, d), (None, None)),
        "tm.w1": ((d, 5 * LORA_MIX), ("d_model", None)),
        "tm.w2": ((5, LORA_MIX, d), (None, None, "d_model")),
        # data-dependent decay
        "tm.decay_base": ((d,), (None,)),
        "tm.dw1": ((d, LORA_DECAY), ("d_model", None)),
        "tm.dw2": ((LORA_DECAY, d), (None, "d_model")),
        "tm.bonus": ((h, n), ("heads", None)),
        "tm.wr": ((d, d), ("d_model", "heads_x")),
        "tm.wk": ((d, d), ("d_model", "heads_x")),
        "tm.wv": ((d, d), ("d_model", "heads_x")),
        "tm.wg": ((d, d), ("d_model", "heads_x")),
        "tm.wo": ((d, d), ("heads_x", "d_model")),
        "tm.ln_x.scale": ((d,), (None,)), "tm.ln_x.bias": ((d,), (None,)),
        # channel-mix
        "cm.mu_k": ((d,), (None,)), "cm.mu_r": ((d,), (None,)),
        "cm.wk": ((d, f), ("d_model", "d_ff")),
        "cm.wv": ((f, d), ("d_ff", "d_model")),
        "cm.wr": ((d, d), ("d_model", None)),
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int, seq: int,
                    dtype: torch.dtype, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    n = cfg.rwkv_head_size
    h = d // n
    return {
        "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        # wkv state is f32: it integrates over the whole context
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32,
                           device=device),
    }


def wkv_step(state: torch.Tensor, r, k, v, w, u
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One WKV6 step.  state: (B,H,N,N) [key x value]; r/k/v/w: (B,H,N);
    u: (H,N).  Returns (new_state, y (B,H,N))."""
    kv = k[..., :, None] * v[..., None, :]                 # outer product
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    new_state = w[..., None] * state + kv
    return new_state, y


def wkv_scan(state: torch.Tensor, r, k, v, w, u
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence WKV6, one ``wkv_step`` per token.  r/k/v/w: (B,S,H,N)
    f32; u: (H,N).  Returns (final_state, y (B,S,H,N))."""
    ys = []
    for t in range(r.shape[1]):
        state, y = wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return state, torch.stack(ys, dim=1)


def _token_shift(x: torch.Tensor, cache: Cache, key: str,
                 mode: str) -> torch.Tensor:
    """The previous token's activations: the cache's in decode, else x
    shifted right by one with a zero first row."""
    if mode == "decode":
        return cache[key][:, None, :].to(x.dtype)
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _ddlerp(params, x: torch.Tensor, dx: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift mixing -> (xw, xk, xv, xr, xg)."""
    mix_in = x + dx * params["tm.mu_x"]
    lora = torch.tanh(matmul(mix_in, params["tm.w1"]))
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, LORA_MIX)
    delta = torch.einsum("bsir,ird->bsid", lora, params["tm.w2"])
    mixes = params["tm.mu"][None, None] + delta            # (B,S,5,d)
    return tuple(x + dx * mixes[:, :, i] for i in range(5))


def rwkv_time_mix(cfg: ModelConfig, params, x: torch.Tensor, *,
                  mode: str, cache: Cache, backend: str = "cuda"
                  ) -> Tuple[torch.Tensor, Cache]:
    b, s, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    dx = _token_shift(x, cache, "tm_x", mode) - x

    xw, xk, xv, xr, xg = _ddlerp(params, x, dx)
    r = matmul(xr, params["tm.wr"])
    k = matmul(xk, params["tm.wk"])
    v = matmul(xv, params["tm.wv"])
    g = F.silu(matmul(xg, params["tm.wg"]))
    decay_in = params["tm.decay_base"] + matmul(
        torch.tanh(matmul(xw, params["tm.dw1"])), params["tm.dw2"])
    w = torch.exp(-torch.exp(decay_in.float()))           # (0,1) decay

    def heads(t):
        return t.reshape(b, s, h, n).float()

    r_, k_, v_, w_ = heads(r), heads(k), heads(v), heads(w)
    u = params["tm.bonus"].float()

    if mode == "decode":
        state, y = wkv_step(cache["wkv"], r_[:, 0], k_[:, 0], v_[:, 0],
                            w_[:, 0], u)
        y = y[:, None]                                    # (B,1,H,N)
    elif backend == "reference":
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32,
                             device=x.device)
        state, y = wkv_scan(state0, r_, k_, v_, w_, u)
    else:
        y, state = wkv6_kernel.wkv6(r_, k_, v_, w_, u)

    # per-head group norm
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d).to(x.dtype)
    y = y * params["tm.ln_x.scale"] + params["tm.ln_x.bias"]
    y = matmul(y * g, params["tm.wo"])

    tm_x = x[:, -1].to(torch.bfloat16)
    if mode == "decode":
        cache["tm_x"].copy_(tm_x)
        cache["wkv"].copy_(state)
        return y, {"tm_x": cache["tm_x"], "wkv": cache["wkv"]}
    return y, {"tm_x": tm_x, "wkv": state}


def rwkv_channel_mix(cfg: ModelConfig, params, x: torch.Tensor, *,
                     mode: str, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    dx = _token_shift(x, cache, "cm_x", mode) - x
    xk = x + dx * params["cm.mu_k"]
    xr = x + dx * params["cm.mu_r"]
    k = torch.square(torch.relu(matmul(xk, params["cm.wk"])))
    kv = matmul(k, params["cm.wv"])
    out = torch.sigmoid(matmul(xr, params["cm.wr"])) * kv
    cm_x = x[:, -1].to(torch.bfloat16)
    if mode == "decode":
        cache["cm_x"].copy_(cm_x)
        return out, {"cm_x": cache["cm_x"]}
    return out, {"cm_x": cm_x}


def table(cfg: ModelConfig) -> ParamTable:
    return rwkv_table(cfg)


def apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
          cache: Cache, positions: torch.Tensor,
          index: Optional[int] = None, backend: str = "cuda"
          ) -> Tuple[torch.Tensor, Cache, Aux]:
    del positions, index                # RWKV has no positional input
    h = layer_norm(x, params["ln1.scale"], params["ln1.bias"], cfg.norm_eps)
    a, c_tm = rwkv_time_mix(cfg, params, h, mode=mode, cache=cache,
                            backend=backend)
    x = x + a
    h = layer_norm(x, params["ln2.scale"], params["ln2.bias"], cfg.norm_eps)
    m, c_cm = rwkv_channel_mix(cfg, params, h, mode=mode, cache=cache)
    x = x + m
    return x, {**c_tm, **c_cm}, {}


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return init_rwkv_cache(cfg, batch, seq, dtype, device)
