"""Whisper-style encoder-decoder backbone: port of
``repro/models/encdec.py`` for serving (prefill and decode) and training
(``train_loss``, on the plain attention) on one GPU.

As in the reference the audio front end is a stub: a prefill takes
precomputed frame embeddings ``batch["frames"]`` (B, S_enc, d_model).
The backbone is pre-LN with biased projections (k has no bias; q and v
do), a tanh-approximated GELU MLP (``jax.nn.gelu``'s default), and
sinusoidal positions, in f32, added to frames and token embeddings.

``EncDec`` holds one ``TableModule`` per encoder and decoder layer; its
``table_entries`` map the reference's stacked names (``enc.self.wq`` of
shape (L, d, H, D)) onto them, as ``LM``'s do.  Prefill runs the
encoder's self-attention (bidirectional), the decoder's self-attention
(causal) and its cross-attention over the encoder output (bidirectional,
Sq != Sk in general) through K4 with ``backend="cuda"`` and through the
plain ``full_attention`` with ``"reference"``.  Decode caches are
per decoder layer (``dec.l{j}``): self K/V written each step, cross K/V
computed at prefill.  Decode attends over the whole cross cache with no
mask, as the reference does (ROADMAP C16).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.models import attention
from repro_torch.models.blocks_attn import project
from repro_torch.models.common import (ParamTable, Params, TableModel,
                                       TableModule, chunked_softmax_xent,
                                       embed, layer_norm, matmul,
                                       merge_tables, prefix_table,
                                       stack_table, unembed)

#: ``dec.l{j}`` -> {"self_k", "self_v", "cross_k", "cross_v"}, each
#: (B, H, S, D).
Caches = Dict[str, Dict[str, torch.Tensor]]


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(...,) positions -> (..., d) f32: [sin | cos] of position x
    10000^(-i / (d/2))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------
# Param tables
# ----------------------------------------------------------------------

def _attn_table(cfg: ModelConfig, name: str) -> ParamTable:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        f"{name}.wq": ((d, h, hd), ("d_model", "heads", "head_dim")),
        f"{name}.wk": ((d, h, hd), ("d_model", "heads", "head_dim")),
        f"{name}.wv": ((d, h, hd), ("d_model", "heads", "head_dim")),
        f"{name}.wo": ((h, hd, d), ("heads", "head_dim", "d_model")),
        f"{name}.bq": ((h, hd), ("heads", "head_dim")),
        f"{name}.bv": ((h, hd), ("heads", "head_dim")),
        f"{name}.bo": ((d,), (None,)),
        f"{name}_ln.scale": ((d,), (None,)),
        f"{name}_ln.bias": ((d,), (None,)),
    }


def _mlp_table(cfg: ModelConfig) -> ParamTable:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp.w_in": ((d, f), ("d_model", "d_ff")),
        "mlp.b_in": ((f,), ("d_ff",)),
        "mlp.w_out": ((f, d), ("d_ff", "d_model")),
        "mlp.b_out": ((d,), (None,)),
        "mlp_ln.scale": ((d,), (None,)),
        "mlp_ln.bias": ((d,), (None,)),
    }


def enc_block_table(cfg: ModelConfig) -> ParamTable:
    return merge_tables(_attn_table(cfg, "self"), _mlp_table(cfg))


def dec_block_table(cfg: ModelConfig) -> ParamTable:
    return merge_tables(_attn_table(cfg, "self"), _attn_table(cfg, "cross"),
                        _mlp_table(cfg))


def _top_table(cfg: ModelConfig) -> ParamTable:
    d = cfg.d_model
    return {
        "embed": ((cfg.vocab_size, d), ("vocab", "d_model")),
        "enc_ln_post.scale": ((d,), (None,)),
        "enc_ln_post.bias": ((d,), (None,)),
        "dec_ln_post.scale": ((d,), (None,)),
        "dec_ln_post.bias": ((d,), (None,)),
    }


def param_table(cfg: ModelConfig) -> ParamTable:
    return merge_tables(
        _top_table(cfg),
        prefix_table("enc", stack_table(enc_block_table(cfg),
                                        cfg.n_encoder_layers)),
        prefix_table("dec", stack_table(dec_block_table(cfg),
                                        cfg.n_layers)),
    )


class EncDec(TableModel):
    """The model's parameters: ``top`` (embed, the two post-LNs),
    ``enc[j]`` and ``dec[j]``, one ``TableModule`` per layer named by the
    block tables.  Allocated uninitialized on ``device``; fill with
    ``init_weights`` or ``convert.params_from_numpy``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg

        def shapes(table: ParamTable):
            return {k: shape for k, (shape, _) in table.items()}

        self.top = TableModule(shapes(_top_table(cfg)), dtype, dev)
        self.enc = nn.ModuleList(
            TableModule(shapes(enc_block_table(cfg)), dtype, dev)
            for _ in range(cfg.n_encoder_layers))
        self.dec = nn.ModuleList(
            TableModule(shapes(dec_block_table(cfg)), dtype, dev)
            for _ in range(cfg.n_layers))

    def table_entries(self) -> Iterator[Tuple[str, Tuple[int, ...],
                                              List[torch.Tensor]]]:
        table = param_table(self.cfg)
        for name in _top_table(self.cfg):
            yield name, table[name][0], [self.top.get_parameter(name)]
        for stack, block in (("enc", enc_block_table),
                             ("dec", dec_block_table)):
            layers = getattr(self, stack)
            for key in block(self.cfg):
                name = f"{stack}.{key}"
                yield name, table[name][0], [l.get_parameter(key)
                                             for l in layers]

    def weights(self) -> Tuple[Params, List[Params], List[Params]]:
        """(the top tensors, per-layer encoder dicts, decoder dicts)."""
        return (self.top.params(), [layer.params() for layer in self.enc],
                [layer.params() for layer in self.dec])


#: The family's model class, as ``api.model_class`` finds it.
Model = EncDec


def weights(cfg: ModelConfig, params
            ) -> Tuple[Params, List[Params], List[Params]]:
    """``params``, an ``EncDec`` or the reference's flat dict (stacked
    ``enc.*``/``dec.*`` entries), as ``EncDec.weights`` lays them out; a
    layer's tensors are views of the stacked ones (``unbind``)."""
    if isinstance(params, EncDec):
        return params.weights()
    top = {k: params[k] for k in _top_table(cfg)}

    def layers(stack: str, block: ParamTable, n: int) -> List[Params]:
        per = {key: params[f"{stack}.{key}"].unbind(0) for key in block}
        return [{key: per[key][j] for key in block} for j in range(n)]

    return (top, layers("enc", enc_block_table(cfg), cfg.n_encoder_layers),
            layers("dec", dec_block_table(cfg), cfg.n_layers))


# ----------------------------------------------------------------------
# Sub-layers
# ----------------------------------------------------------------------

def _proj_qkv(p, name: str, xq: torch.Tensor, xkv: torch.Tensor):
    """q and v biased, k not; each (B, H, S, D)."""
    q = project(xq, p[f"{name}.wq"]) + p[f"{name}.bq"]
    k = project(xkv, p[f"{name}.wk"])
    v = project(xkv, p[f"{name}.wv"]) + p[f"{name}.bv"]
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _out_proj(p, name: str, out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, d)."""
    b, _, s, _ = out.shape
    wo = p[f"{name}.wo"]
    return (matmul(out.transpose(1, 2).reshape(b, s, -1),
                   wo.reshape(-1, wo.shape[-1])) + p[f"{name}.bo"])


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(matmul(x, p["mlp.w_in"]) + p["mlp.b_in"], approximate="tanh")
    return matmul(h, p["mlp.w_out"]) + p["mlp.b_out"]


def _ln(p, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm(x, p[f"{name}.scale"], p[f"{name}.bias"], eps)


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool,
            backend: str) -> torch.Tensor:
    """Prefill attention: K4 on ``backend="cuda"``, else plain."""
    if backend == "reference":
        return attention.full_attention(q, k, v, causal=causal,
                                        q_block=cfg.q_block)
    return fa_kernel.flash_attention(q, k, v, causal=causal)


def _positions(s: int, x: torch.Tensor) -> torch.Tensor:
    return sinusoid(torch.arange(s, device=x.device),
                    x.shape[-1]).to(x.dtype)


# ----------------------------------------------------------------------
# Encoder and decoder
# ----------------------------------------------------------------------

def _layer(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _enc_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
               backend: str) -> torch.Tensor:
    h = _ln(p, "self_ln", x, cfg.norm_eps)
    q, k, v = _proj_qkv(p, "self", h, h)
    x = x + _out_proj(p, "self", _attend(cfg, q, k, v, causal=False,
                                         backend=backend))
    return x + _mlp(p, _ln(p, "mlp_ln", x, cfg.norm_eps))


def _encode(cfg: ModelConfig, top: Params, enc: List[Params],
            frames: torch.Tensor, backend: str,
            remat: bool = False) -> torch.Tensor:
    x = frames + _positions(frames.shape[1], frames)[None]
    for p in enc:
        x = _layer(_enc_layer, remat, cfg, p, x, backend)
    return _ln(top, "enc_ln_post", x, cfg.norm_eps)


def encode(cfg: ModelConfig, model: EncDec, frames: torch.Tensor,
           backend: str = "cuda") -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings (stub front end)."""
    top, enc, _ = model.weights()
    return _encode(cfg, top, enc, frames, backend)


def _dec_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
               enc_out: torch.Tensor, backend: str
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer over the whole sequence: (x, its caches)."""
    h = _ln(p, "self_ln", x, cfg.norm_eps)
    q, k, v = _proj_qkv(p, "self", h, h)
    x = x + _out_proj(p, "self", _attend(cfg, q, k, v, causal=True,
                                         backend=backend))
    h = _ln(p, "cross_ln", x, cfg.norm_eps)
    qc, kc, vc = _proj_qkv(p, "cross", h, enc_out)
    x = x + _out_proj(p, "cross", _attend(cfg, qc, kc, vc, causal=False,
                                          backend=backend))
    x = x + _mlp(p, _ln(p, "mlp_ln", x, cfg.norm_eps))
    return x, {"self_k": k, "self_v": v, "cross_k": kc, "cross_v": vc}


def _dec_train_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    return _dec_layer(cfg, p, x, enc_out, "reference")[0]


def _dec_prefill(cfg: ModelConfig, dec: List[Params], x: torch.Tensor,
                 enc_out: torch.Tensor, backend: str
                 ) -> Tuple[torch.Tensor, Caches]:
    caches: Caches = {}
    for j, p in enumerate(dec):
        x, caches[f"dec.l{j}"] = _dec_layer(cfg, p, x, enc_out, backend)
    return x, caches


def _dec_decode(cfg: ModelConfig, dec: List[Params], x: torch.Tensor,
                caches: Caches, index: int) -> Tuple[torch.Tensor, Caches]:
    """One token (B, 1, d) through every decoder layer; self caches
    written in place at ``index``."""
    b = x.shape[0]
    for j, p in enumerate(dec):
        c = caches[f"dec.l{j}"]
        h = _ln(p, "self_ln", x, cfg.norm_eps)
        q, k, v = _proj_qkv(p, "self", h, h)
        kc, vc = attention.update_cache(c["self_k"], c["self_v"], k, v,
                                        index)
        n_pos = kc.shape[2]
        valid = (torch.arange(n_pos, device=x.device) <= index).expand(
            b, n_pos)
        a = attention.decode_attention(q, kc, vc, kv_valid=valid)
        x = x + _out_proj(p, "self", a)
        h = _ln(p, "cross_ln", x, cfg.norm_eps)
        qx = (project(h, p["cross.wq"]) + p["cross.bq"]).transpose(1, 2)
        # no mask: a slot's zero-padded cross keys join the softmax (C16)
        a = attention.decode_attention(qx, c["cross_k"], c["cross_v"])
        x = x + _out_proj(p, "cross", a)
        x = x + _mlp(p, _ln(p, "mlp_ln", x, cfg.norm_eps))
    return x, caches


def _logits(cfg: ModelConfig, top: Params, x: torch.Tensor
            ) -> torch.Tensor:
    x = _ln(top, "dec_ln_post", x, cfg.norm_eps)
    return unembed(x, top["embed"]).float()


def _embed_tokens(cfg: ModelConfig, top: Params, tokens: torch.Tensor
                  ) -> torch.Tensor:
    x = embed(tokens, top["embed"])
    return x + _positions(tokens.shape[1], x)[None]


# ----------------------------------------------------------------------
# Entry points (lm.py's signatures)
# ----------------------------------------------------------------------

def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``encdec.train_loss``: ``params`` an ``EncDec`` or
    the reference's flat dict; ``batch`` {"tokens", "labels", "mask"}
    (B, S) and "frames" (B, S_enc, d).  Encoder and decoder run the plain
    attention, each layer under ``torch.utils.checkpoint`` when
    ``cfg.remat``.  Returns (xent, {"xent", "loss"})."""
    top, enc, dec = weights(cfg, params)
    frames = batch["frames"].to(top["embed"].device)
    enc_out = _encode(cfg, top, enc, frames, "reference", cfg.remat)
    x = _embed_tokens(cfg, top, batch["tokens"])
    for p in dec:
        x = _layer(_dec_train_layer, cfg.remat, cfg, p, x, enc_out)
    x = _ln(top, "dec_ln_post", x, cfg.norm_eps)
    loss = chunked_softmax_xent(x, batch["labels"], top["embed"],
                                batch["mask"], cfg.logit_chunk)
    return loss, {"xent": loss, "loss": loss}


def prefill(cfg: ModelConfig, model: EncDec, batch: Dict[str, Any],
            backend: str = "cuda") -> Tuple[torch.Tensor, Caches]:
    """``batch`` = {"tokens": (B, S), "frames": (B, S_enc, d)}; returns
    (last-position logits (B, 1, V) f32, per-layer caches)."""
    top, enc, dec = model.weights()
    enc_out = _encode(cfg, top, enc, batch["frames"].to(model.device),
                      backend)
    x = _embed_tokens(cfg, top, batch["tokens"])
    x, caches = _dec_prefill(cfg, dec, x, enc_out, backend)
    return _logits(cfg, top, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, model: EncDec, caches: Caches,
                batch: Dict[str, Any], backend: str = "cuda"
                ) -> Tuple[torch.Tensor, Caches]:
    """``batch`` = {"tokens": (B, 1), "index": int position}; the self
    caches are written in place.  Decode runs no kernel, so ``backend``
    changes nothing here."""
    del backend
    index = int(batch["index"])
    top, _, dec = model.weights()
    x = embed(batch["tokens"], top["embed"])
    x = x + sinusoid(torch.tensor(index, device=x.device),
                     cfg.d_model).to(x.dtype)
    x, caches = _dec_decode(cfg, dec, x, caches, index)
    return _logits(cfg, top, x), caches


def init_caches(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype,
                device: torch.device) -> Caches:
    """Self caches of length ``seq``, cross caches of ``seq *
    encoder_seq_ratio`` (at least 1)."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    s_enc = max(int(seq * cfg.encoder_seq_ratio), 1)

    def zeros(s):
        return torch.zeros((batch, h, s, hd), dtype=dtype, device=device)

    return {f"dec.l{j}": {"self_k": zeros(seq), "self_v": zeros(seq),
                          "cross_k": zeros(s_enc), "cross_v": zeros(s_enc)}
            for j in range(cfg.n_layers)}
