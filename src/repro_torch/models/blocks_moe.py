"""Mixture-of-Experts FFN (OLMoE, DeepSeek) and MLA attention
(DeepSeek-V2): port of ``repro/models/blocks_moe.py`` for one GPU.

MoE routes tokens in chunks of ``MOE_CHUNK``, each expert taking at most
``capacity`` of a chunk's (token, choice) pairs in arrival order (token
major, choice minor); the rest are dropped (``moe_dropped``).  Two
dispatches route alike: ``_route_chunk_gather`` (the default) moves
tokens by index gathers, ``_route_chunk`` (GShard) by one-hot (T, E, C)
einsums.  They combine differently, as in the reference: gather weights
each kept choice by its own gate, GShard by its token's kept gate sum
(ROADMAP C17, reproduced).  The reference's expert parallelism across a
mesh (``_moe_apply_ep``, ``shard_map`` + ``all_to_all``) does not apply
on one card and is not ported (ROADMAP A11.7).

Top-k follows ``jax.lax.top_k``: a tie goes to the lower expert index
(a stable sort of ``-probs``; ``torch.topk`` promises no order).

MLA caches the compressed latent ``c_kv`` (B, S, kv_lora_rank) and the
rotary key ``k_pe`` (B, S, rope dims).  Decode attends in the latent
space (weight absorption: the cache is never decompressed); prefill
decompresses K/V and attends with q·k ``qk_nope + qk_rope`` wide and v
``v_head_dim`` wide.  K4 takes one head dim for q, k and v, so MLA's
prefill runs the plain ``full_attention`` on every backend, as the
reference runs its plain attention there.

Expert and router products are ``torch`` matmuls (the reference
computes them outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks_attn
from repro_torch.models.common import ParamTable, matmul, rms_norm, rope

Aux = Dict[str, torch.Tensor]
Cache = Optional[Dict[str, torch.Tensor]]

MOE_CHUNK = 2048  # tokens per dispatch chunk


# ----------------------------------------------------------------------
# MoE FFN
# ----------------------------------------------------------------------

def moe_table(cfg: ModelConfig) -> ParamTable:
    d = cfg.d_model
    m = cfg.moe
    f = m.d_ff_expert or cfg.d_ff
    t: ParamTable = {
        "moe.router": ((d, m.n_experts), ("d_model", "experts")),
        "moe.w_gate": ((m.n_experts, d, f), ("experts", "d_model", "d_ff")),
        "moe.w_up": ((m.n_experts, d, f), ("experts", "d_model", "d_ff")),
        "moe.w_down": ((m.n_experts, f, d), ("experts", "d_ff", "d_model")),
        "moe_norm.scale": ((d,), (None,)),
    }
    if m.n_shared:
        fs = f * m.n_shared
        t["moe.shared_gate"] = ((d, fs), ("d_model", "d_ff"))
        t["moe.shared_up"] = ((d, fs), ("d_model", "d_ff"))
        t["moe.shared_down"] = ((fs, d), ("d_ff", "d_model"))
    return t


def route(cfg: ModelConfig, params, xc: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of one chunk xc (T, d): (f32 logits (T, E), probs (T, E),
    renormalized top-k gates (T, k), expert indices (T, k) int64, ties to
    the lower index as ``jax.lax.top_k``)."""
    logits = matmul(xc, params["moe.router"]).float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(-probs, dim=-1, stable=True).indices[:, :cfg.moe.top_k]
    gates = torch.gather(probs, 1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def arrival_positions(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx (T, k) -> (T*k,) each (token, choice)'s position within its
    expert, in token-major, choice-minor arrival order."""
    flat = idx.reshape(-1)
    # (E, T*k): the count runs along the inner dim (CUDA's scan along an
    # outer dim takes ~1 ms at T*k = 8192)
    onehot = F.one_hot(flat, n_experts).to(torch.int32).t().contiguous()
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return pos[flat, torch.arange(flat.shape[0], device=flat.device)]


def _aux(cfg: ModelConfig, logits, probs, idx, keep) -> Aux:
    m = cfg.moe
    me = probs.mean(0)
    ce = F.one_hot(idx, m.n_experts).float().sum(1).mean(0)
    return {
        "moe_aux": m.n_experts * (me * ce).sum() * m.aux_loss,
        "moe_z": torch.logsumexp(logits, -1).square().mean()
        * m.router_z_loss,
        "moe_dropped": (1.0 - keep.float()).sum(),
    }


def _experts(params, xin: torch.Tensor) -> torch.Tensor:
    """(E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = matmul(xin, params["moe.w_gate"])
    u = matmul(xin, params["moe.w_up"])
    return matmul(F.silu(g) * u, params["moe.w_down"])


def _route_chunk(cfg: ModelConfig, params, xc: torch.Tensor,
                 capacity: int) -> Tuple[torch.Tensor, Aux]:
    """GShard dispatch: xc (T, d) -> (T, d) expert mixture through
    one-hot (T, E, C) dispatch and combine tensors."""
    m = cfg.moe
    logits, probs, gates, idx = route(cfg, params, xc)
    pos = arrival_positions(idx, m.n_experts).reshape(idx.shape)
    keep = pos < capacity
    onehot_e = F.one_hot(idx, m.n_experts).float()               # (T,k,E)
    onehot_c = (F.one_hot(torch.clamp(pos, max=capacity - 1).long(),
                          capacity).float()
                * keep[..., None])                                 # (T,k,C)
    dispatch = torch.einsum("tke,tkc->tec", onehot_e, onehot_c)
    # the reference's einsum "tec,tk->tec" sums the kept gates over k:
    # every kept choice is weighted by its token's kept gate sum (C17)
    combine = dispatch * (gates * keep).sum(1)[:, None, None]
    xin = torch.einsum("tec,td->ecd", dispatch.to(xc.dtype), xc)
    xout = _experts(params, xin)
    y = torch.einsum("tec,ecd->td", combine.to(xout.dtype), xout)
    return y, _aux(cfg, logits, probs, idx, keep)


def _route_chunk_gather(cfg: ModelConfig, params, xc: torch.Tensor,
                        capacity: int) -> Tuple[torch.Tensor, Aux]:
    """Gather dispatch: ``_route_chunk``'s routing with the permutation
    on index arrays and two gathers of tokens (token -> expert slot,
    expert slot -> token), each kept choice weighted by its own gate."""
    m = cfg.moe
    t, d = xc.shape
    k = m.top_k
    logits, probs, gates, idx = route(cfg, params, xc)
    pos = arrival_positions(idx, m.n_experts)
    keep = pos < capacity
    dropped_bin = m.n_experts * capacity
    slot = torch.where(keep, idx.reshape(-1) * capacity + pos, dropped_bin)

    # inverse permutation: the token in each (expert, slot); t = pad row
    src = torch.full((dropped_bin + 1,), t, dtype=torch.int64,
                     device=xc.device)
    src[slot] = torch.arange(t * k, device=xc.device) // k
    src = src[:-1].reshape(m.n_experts, capacity)

    xpad = torch.cat([xc, xc.new_zeros((1, d))])
    xout = _experts(params, xpad[src])                        # (E, C, d)
    flat_out = torch.cat([xout.reshape(dropped_bin, d),
                          xout.new_zeros((1, d))])
    w = (gates.reshape(-1) * keep).to(xc.dtype)
    y = (flat_out[slot] * w[:, None]).reshape(t, k, d).sum(1)
    return y, _aux(cfg, logits, probs, idx, keep.reshape(t, k))


def moe_apply(cfg: ModelConfig, params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, d).  Routed in chunks of ``MOE_CHUNK`` tokens (one
    chunk, at the whole count's capacity, when the count is not a
    multiple); aux terms averaged over chunks, ``moe_dropped`` summed;
    shared experts added densely."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    n_tok = tokens.shape[0]
    chunk = min(MOE_CHUNK, n_tok)
    n_chunks = max(n_tok // chunk, 1)
    capacity = max(int(m.top_k * chunk * m.capacity_factor / m.n_experts), 4)
    route_fn = (_route_chunk_gather if m.dispatch == "gather"
                else _route_chunk)

    if n_chunks * chunk != n_tok:  # ragged tail: single-chunk fallback
        y, aux = route_fn(cfg, params, tokens, max(
            int(m.top_k * n_tok * m.capacity_factor / m.n_experts), 4))
    else:
        ys, auxs = zip(*(route_fn(cfg, params, xc, capacity)
                         for xc in tokens.split(chunk)))
        y = torch.cat(ys)
        aux = {key: torch.stack([a[key] for a in auxs]).sum() / n_chunks
               for key in auxs[0]}
        aux["moe_dropped"] = aux["moe_dropped"] * n_chunks  # total

    y = y.reshape(b, s, d)
    if m.n_shared:
        g = matmul(x, params["moe.shared_gate"])
        u = matmul(x, params["moe.shared_up"])
        y = y + matmul(F.silu(g) * u, params["moe.shared_down"])
    return y, aux


# ----------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ----------------------------------------------------------------------

def mla_table(cfg: ModelConfig) -> ParamTable:
    d, h = cfg.d_model, cfg.n_heads
    a = cfg.mla
    qk = a.qk_nope_dim + a.qk_rope_dim
    return {
        "mla.wq": ((d, h, qk), ("d_model", "heads", None)),
        "mla.w_dkv": ((d, a.kv_lora_rank + a.qk_rope_dim), ("d_model", None)),
        "mla.kv_norm.scale": ((a.kv_lora_rank,), (None,)),
        "mla.w_uk": ((a.kv_lora_rank, h, a.qk_nope_dim),
                     (None, "heads", None)),
        "mla.w_uv": ((a.kv_lora_rank, h, a.v_head_dim),
                     (None, "heads", None)),
        "mla.wo": ((h, a.v_head_dim, d), ("heads", None, "d_model")),
        "attn_norm.scale": ((d,), (None,)),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    a = cfg.mla
    return {
        "c_kv": torch.zeros((batch, seq, a.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, seq, a.qk_rope_dim), dtype=dtype,
                            device=device),
    }


def mla_apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
              cache: Cache, positions: torch.Tensor,
              index: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """x: (B, S, d) -> (B, S, d).  Decode writes the caches in place at
    ``index`` (clamped into range, as ``dynamic_update_slice``) and
    attends over positions <= ``index``."""
    a = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5

    q = blocks_attn.project(x, params["mla.wq"])              # (B,S,H,qk)
    q_nope, q_pe = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)

    ckv_full = matmul(x, params["mla.w_dkv"])                 # (B,S,R+r)
    c_kv = rms_norm(ckv_full[..., :a.kv_lora_rank],
                    params["mla.kv_norm.scale"], cfg.norm_eps)
    k_pe = rope(ckv_full[..., a.kv_lora_rank:], positions, cfg.rope_theta)

    w_uk, w_uv = params["mla.w_uk"], params["mla.w_uv"]
    if mode == "decode":
        assert cache is not None and index is not None
        c_cache, p_cache = cache["c_kv"], cache["k_pe"]
        at = min(max(int(index), 0), c_cache.shape[1] - 1)
        c_cache[:, at:at + 1] = c_kv.to(c_cache.dtype)
        p_cache[:, at:at + 1] = k_pe.to(p_cache.dtype)
        # absorbed decode: scores and context in the compressed space
        q_c = torch.einsum("bshk,rhk->bshr", *_promoted(q_nope, w_uk))
        scores = (torch.einsum("bshr,btr->bhst", q_c.float(),
                               c_cache.float())
                  + torch.einsum("bshk,btk->bhst", q_pe.float(),
                                 p_cache.float())) * scale
        valid = torch.arange(c_cache.shape[1], device=x.device) <= index
        scores = torch.where(valid, scores, attention.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype),
                           c_cache)
        out = torch.einsum("bshr,rhv->bshv", *_promoted(ctx, w_uv))
        new_cache = {"c_kv": c_cache, "k_pe": p_cache}
    else:
        # prefill and train: decompress K/V and attend (plain: v is
        # narrower)
        k_nope = torch.einsum("bsr,rhk->bshk", *_promoted(c_kv, w_uk))
        v = torch.einsum("bsr,rhv->bshv", *_promoted(c_kv, w_uv))
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            b, s, h, a.qk_rope_dim).to(k_nope.dtype)], dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        out = attention.full_attention(
            qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, q_block=cfg.q_block, scale=scale).transpose(1, 2)
        new_cache = (None if mode == "train" else
                     {"c_kv": c_kv.to(x.dtype), "k_pe": k_pe.to(x.dtype)})

    wo = params["mla.wo"]
    y = matmul(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]))
    return y, new_cache


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """(a, b) in their promoted dtype, as ``jnp.einsum`` computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# ----------------------------------------------------------------------
# Full MoE decoder blocks
# ----------------------------------------------------------------------

def _attn(cfg: ModelConfig, params, h, *, mode, cache, positions, index,
          backend):
    if cfg.mla:
        return mla_apply(cfg, params, h, mode=mode, cache=cache,
                         positions=positions, index=index)
    return blocks_attn.attn_apply(cfg, params, h, mode=mode, cache=cache,
                                  positions=positions, index=index,
                                  backend=backend)


def table(cfg: ModelConfig) -> ParamTable:
    """MoE block: (MLA | GQA) attention + MoE FFN."""
    at = mla_table(cfg) if cfg.mla else blocks_attn.attn_table(cfg)
    return {**at, **moe_table(cfg)}


def apply(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
          cache: Cache, positions: torch.Tensor,
          index: Optional[int] = None, backend: str = "cuda"
          ) -> Tuple[torch.Tensor, Cache, Aux]:
    h = rms_norm(x, params["attn_norm.scale"], cfg.norm_eps)
    a, new_cache = _attn(cfg, params, h, mode=mode, cache=cache,
                         positions=positions, index=index, backend=backend)
    x = x + a
    hh = rms_norm(x, params["moe_norm.scale"], cfg.norm_eps)
    y, aux = moe_apply(cfg, params, hh)
    return x + y, new_cache, aux


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    if cfg.mla:
        return init_mla_cache(cfg, batch, seq, dtype, device)
    return blocks_attn.init_attn_cache(cfg, batch, seq, dtype, device)


# Dense-FFN + MLA block (DeepSeek's first_dense_layers)

def dense_mla_table(cfg: ModelConfig) -> ParamTable:
    at = mla_table(cfg) if cfg.mla else blocks_attn.attn_table(cfg)
    return {**at, **blocks_attn.mlp_table(cfg, d_ff=cfg.moe.d_ff_dense)}


def dense_mla_apply(cfg: ModelConfig, params, x: torch.Tensor, *,
                    mode: str, cache: Cache, positions: torch.Tensor,
                    index: Optional[int] = None, backend: str = "cuda"
                    ) -> Tuple[torch.Tensor, Cache, Aux]:
    h = rms_norm(x, params["attn_norm.scale"], cfg.norm_eps)
    a, new_cache = _attn(cfg, params, h, mode=mode, cache=cache,
                         positions=positions, index=index, backend=backend)
    x = x + a
    h = rms_norm(x, params["mlp_norm.scale"], cfg.norm_eps)
    return x + blocks_attn.mlp_apply(cfg, params, h), new_cache, {}
