"""Recurrent blocks: port of ``repro/models/blocks_rnn.py``, both halves:
RWKV6 "Finch" (time mix, channel mix, the WKV6 recurrence) and the
RG-LRU of RecurrentGemma / Griffin (the recurrent block, its depthwise
causal conv and the GeGLU MLP).

``wkv_scan`` is the WKV6 recurrence over a sequence, one ``wkv_step``
per token: the plain version of K3, the CUDA kernel
(``repro_torch.kernels.wkv6``) that prefill runs on CUDA tensors.
``wkv_chunked`` is the same recurrence a chunk of steps at a time, as
matrix products (no serving path calls it).  K3 runs the same chunk
algebra with its decays as products of w over step ranges instead of
exponentials of log-decay differences, which keep f32 precision where
cumulative log-decays grow large.
``rglru_scan`` is the RG-LRU recurrence, one ``a_t * h + x_t`` per
token: the plain version of K2's scan entry (``repro_torch.kernels.
rglru.rglru``).  ``rglru_gated_scan`` is the whole RG-LRU between its
matrix products (gates, recurrence, branch product): the plain version
of K2's gated entry, which the RG-LRU layer runs on CUDA tensors in
prefill and in decode (one step from the cache's h).

Block contract (shared with ``blocks_attn``):

  table(cfg) -> ParamTable
  apply(cfg, params, x, *, mode, cache, positions, index, backend)
      -> (y, new_cache, aux)

On meta tensors under a ``repro_torch.counting`` counter (the dry run), the
per-token loops of ``wkv_scan`` and ``rglru_scan`` run two steps and
count the rest (``counting.trip_scan``), differentiably; on CPU and CUDA
tensors they run every step.

``mode`` is "prefill", "decode" or "train".  In decode the cache's
tensors are updated in place; train returns no cache and runs the plain
recurrences (``wkv_scan`` from a zero state, ``rglru_gated_scan``) under
autograd, as the reference trains on ``wkv_scan`` and ``rglru_scan``.
``backend`` is "cuda" (the kernels, for CUDA tensors) or "reference"
(plain versions).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import rglru as rglru_kernel
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch import counting
from repro_torch.models.common import (ParamTable, layer_norm, matmul,
                                       rms_norm)

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
    if counting.tripping(r):
        return counting.trip_scan(wkv_step, state, (r, k, v, w), (u,))
    ys = []
    for t in range(r.shape[1]):
        state, y = wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return state, torch.stack(ys, dim=1)


WKV_CHUNK = 32   # chunked-formulation block length


def wkv_chunked(state: torch.Tensor, r, k, v, w, u,
                chunk: int = WKV_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6: the recurrence of ``wkv_scan``, ``chunk`` steps at a
    time.  Within a chunk, with L_t = sum_{tau<=t} log w_tau (w clamped
    at 1e-30, so L is finite) and L_{-1} = 0:

      y_t = (r_t . e^{L_{t-1}}) @ S_0                       (inter-chunk)
          + sum_{s<t} [sum_i r_t k_s e^{L_{t-1}-L_s}] v_s   (intra-chunk)
          + (r_t . u . k_t) v_t                             (bonus)
      S'  = e^{L_{C-1}} . S_0 + (k . e^{L_{C-1}-L})^T @ V

    Every exponent is of a non-positive quantity, so every factor lies in
    [0, 1] (the factored r*P and k/P form overflows).  Port of the JAX
    package's ``wkv_chunked``, which falls back to ``wkv_scan`` when
    ``chunk`` does not divide S; this one pads the last chunk instead
    with r = k = v = 0 and w = 1 (a zero log-decay), as K3 does.

    r/k/v/w: (B, S, H, N) f32; u: (H, N); state: (B, H, N, N).  Returns
    (final_state, y (B, S, H, N)), as ``wkv_scan``."""
    b, s, h, n = r.shape
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def to_chunks(x, fill):
        x = F.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc = (to_chunks(x, 0.0) for x in (r, k, v))
    log_w = torch.log(torch.clamp_min(to_chunks(w, 1.0), 1e-30))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    ys = []
    for rt, kt, vt, lw in zip(rc, kc, vc, log_w):      # (B, H, C, N) each
        L = torch.cumsum(lw, dim=2)
        L_prev = L - lw
        y_inter = torch.einsum("bhtn,bhnm->bhtm", rt * torch.exp(L_prev),
                               state)
        diff = L_prev[:, :, :, None, :] - L[:, :, None, :, :]
        D = torch.where(tri[None, None, :, :, None],
                        torch.exp(torch.clamp_max(diff, 0.0)), 0.0)
        A = torch.einsum("bhtn,bhsn,bhtsn->bhts", rt, kt, D)
        bonus = torch.sum(rt * u[None, :, None, :] * kt, dim=-1)
        y_intra = torch.einsum("bhts,bhsm->bhtm", A, vt) \
            + bonus[..., None] * vt
        decay_to_end = torch.exp(L[:, :, -1:, :] - L)
        state = torch.exp(L[:, :, -1, :])[..., None] * state + torch.einsum(
            "bhsn,bhsm->bhnm", kt * decay_to_end, vt)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, nc * chunk, h, n)
    return state, y[:, :s]


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
    elif backend == "reference" or mode == "train":
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

    if mode == "train":
        return y, None
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
    if mode == "train":
        return out, None
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
    return x, (None if mode == "train" else {**c_tm, **c_cm}), {}


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return init_rwkv_cache(cfg, batch, seq, dtype, device)


# ======================================================================
# RG-LRU (RecurrentGemma / Griffin)
# ======================================================================

_RGLRU_C = 8.0


def rglru_table(cfg: ModelConfig) -> ParamTable:
    d = cfg.d_model
    w = cfg.rnn_width or d
    cw = cfg.conv_width
    return {
        "norm.scale": ((d,), (None,)),
        "rg.w_branch": ((d, w), ("d_model", "rnn")),
        "rg.w_in": ((d, w), ("d_model", "rnn")),
        "rg.conv_w": ((cw, w), (None, "rnn")),
        "rg.conv_b": ((w,), ("rnn",)),
        "rg.w_rgate": ((w, w), ("rnn", None)),
        "rg.w_igate": ((w, w), ("rnn", None)),
        "rg.rgate_bias": ((w,), ("rnn",)),
        "rg.igate_bias": ((w,), ("rnn",)),
        "rg.lambda": ((w,), ("rnn",)),
        "rg.w_out": ((w, d), ("rnn", "d_model")),
        # GeGLU MLP
        "mlp.w_gate": ((d, cfg.d_ff), ("d_model", "d_ff")),
        "mlp.w_up": ((d, cfg.d_ff), ("d_model", "d_ff")),
        "mlp.w_down": ((cfg.d_ff, d), ("d_ff", "d_model")),
        "mlp_norm.scale": ((d,), (None,)),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, seq: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    w = cfg.rnn_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        # h is f32 whatever the cache dtype: it integrates the context
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def _causal_conv(params, x: torch.Tensor, state: Optional[torch.Tensor],
                 mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width cw over x (B, S, W): ``conv_w[cw-1]``
    weighs the current token, ``conv_w[0]`` the token cw-1 back.  Returns
    (y, the next conv state: the last cw-1 inputs, zero rows before the
    first).  The reference's prefill fails on a prompt of fewer than
    cw-1 tokens (ROADMAP C8); this takes any length and agrees with it
    wherever it runs."""
    conv_w, conv_b = params["rg.conv_w"], params["rg.conv_b"]
    cw = conv_w.shape[0]
    if mode == "decode":
        hist = torch.cat([state.to(x.dtype), x], dim=1)      # (B, cw, W)
        dt = torch.promote_types(hist.dtype, conv_w.dtype)
        y = torch.einsum("bkw,kw->bw", hist.to(dt), conv_w.to(dt))
        return (y + conv_b)[:, None], hist[:, 1:]
    s = x.shape[1]
    padded = F.pad(x, (0, 0, cw - 1, 0))               # (B, cw-1+S, W)
    pads = [padded[:, cw - 1 - i:cw - 1 - i + s] for i in range(cw)]
    y = sum(pads[cw - 1 - k] * conv_w[k] for k in range(cw))
    return y + conv_b, padded[:, -(cw - 1):]


def _rglru_step(h: torch.Tensor, a_t: torch.Tensor, gx_t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = a_t * h + gx_t
    return h, h


def rglru_scan(a: torch.Tensor, gx: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + gx_t, one step per token.  a/gx: (B, S, W)
    f32; h0: (B, W).  Returns (h_final (B, W), h_all (B, S, W))."""
    if counting.tripping(a):
        return counting.trip_scan(_rglru_step, h0, (a, gx))
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gx[:, t]
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def rglru_gated_scan(gr: torch.Tensor, gi: torch.Tensor, u: torch.Tensor,
                     branch: torch.Tensor, rgate_bias: torch.Tensor,
                     igate_bias: torch.Tensor, lam: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU between its matrix products: the gates from the gate
    products gr, gi (no bias), then ``rglru_scan`` from h0 (None: zeros),
    then the branch product.  The plain version of K2's gated entry
    (``kernels.rglru.rglru_gated``).  The casts are the reference's: the
    gates are sigmoids in the activation dtype, then f32; the recurrence
    runs in f32; its output is cast back to the branch's dtype.  Returns
    (branch * h (B, S, W), h_final (B, W) f32)."""
    r = torch.sigmoid(gr + rgate_bias).float()
    i = torch.sigmoid(gi + igate_bias).float()
    log_a = -_RGLRU_C * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * i * u.float()
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                         device=a.device)
    h_final, h = rglru_scan(a, gated, h0)
    return branch * h.to(branch.dtype), h_final


def rglru_apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                cache: Cache, backend: str = "cuda"
                ) -> Tuple[torch.Tensor, Cache]:
    """The Griffin recurrent block: GeLU branch * RG-LRU branch.  Between
    the matrix products, prefill and decode (one step from the cache's
    h) run K2's gated entry, or with ``backend="reference"`` its plain
    version."""
    branch = F.gelu(matmul(x, params["rg.w_branch"]), approximate="tanh")
    u = matmul(x, params["rg.w_in"])
    u, conv_state = _causal_conv(
        params, u, cache["conv"] if mode == "decode" else None, mode)
    gates = (matmul(u, params["rg.w_rgate"]), matmul(u, params["rg.w_igate"]),
             u, branch, params["rg.rgate_bias"], params["rg.igate_bias"],
             params["rg.lambda"])
    h0 = cache["h"] if mode == "decode" else None
    if backend == "reference" or mode == "train":
        y, h_final = rglru_gated_scan(*gates, h0)
    else:
        # decode writes the new h into the cache's own tensor
        y, h_final = rglru_kernel.rglru_gated(*gates, h0, h_final=h0)

    y = matmul(y, params["rg.w_out"])
    if mode == "train":
        return y, None
    if mode == "decode":
        # the reference's new conv state has the activations' dtype:
        # written in place where the cache has it too (bf16 serving), a
        # new leaf where it has not (f32 weights over a bf16 cache)
        if cache["conv"].dtype == conv_state.dtype:
            conv_state = cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_final)
        return y, {"conv": conv_state, "h": cache["h"]}
    return y, {"conv": conv_state, "h": h_final}


def geglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    g = matmul(x, params["mlp.w_gate"])
    u = matmul(x, params["mlp.w_up"])
    return matmul(F.gelu(g, approximate="tanh") * u, params["mlp.w_down"])


def rglru_block_apply(cfg: ModelConfig, params, x: torch.Tensor, *,
                      mode: str, cache: Cache, positions: torch.Tensor,
                      index: Optional[int] = None, backend: str = "cuda"
                      ) -> Tuple[torch.Tensor, Cache, Aux]:
    del positions, index                # the recurrence has no positions
    h = rms_norm(x, params["norm.scale"], cfg.norm_eps)
    a, new_cache = rglru_apply(cfg, params, h, mode=mode, cache=cache,
                               backend=backend)
    x = x + a
    h = rms_norm(x, params["mlp_norm.scale"], cfg.norm_eps)
    x = x + geglu_mlp(params, h)
    return x, new_cache, {}


def init_cache_rglru(cfg: ModelConfig, batch: int, seq: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    return init_rglru_cache(cfg, batch, seq, dtype, device)
