"""Architecture/config schema: the port's own copy of
``repro/configs/base.py``.

One ``ModelConfig`` instance per architecture (``registry.py``), plus
``reduced()`` variants for CPU smoke tests.  Pure Python, kept field for
field equal to the reference so that both packages size a model alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0          # per-expert intermediate size
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    first_dense_layers: int = 0   # leading dense layers (DeepSeek V2)
    d_ff_dense: int = 0           # intermediate size of those dense layers
    # "gather": index-permutation dispatch (§Perf H3, default);
    # "gshard": one-hot einsum dispatch (paper-era baseline, kept for
    # the ablation benchmark + as the oracle in tests).
    dispatch: str = "gather"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # -- MoE / MLA -----------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # -- hybrid (RecurrentGemma) ----------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","local")
    local_window: int = 0
    rnn_width: int = 0            # RG-LRU recurrent width (0 -> d_model)
    conv_width: int = 4
    # -- RWKV ------------------------------------------------------------
    rwkv_head_size: int = 64
    # -- encoder-decoder (Whisper) ----------------------------------------
    n_encoder_layers: int = 0
    encoder_seq_ratio: float = 1.0  # S_enc = ratio * S_dec (stub frontend)
    # -- VLM stub ----------------------------------------------------------
    n_patches: int = 0            # prepended patch embeddings per sample
    # -- runtime ------------------------------------------------------------
    use_scan: bool = True
    remat: bool = True
    q_block: int = 512
    logit_chunk: int = 1024
    accum_steps: int = 1          # gradient-accumulation microbatches
    # roofline bookkeeping: sub-quadratic context support
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def validate(self) -> "ModelConfig":
        assert self.n_kv_heads == 0 or self.n_heads % self.n_kv_heads == 0
        if self.family == "encdec":
            assert self.n_encoder_layers > 0
        if self.family == "moe":
            assert self.moe is not None
        if self.block_pattern:
            assert self.local_window > 0
        return self


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: tiny widths/layers, small
    vocab, few experts — runs a real forward/train step on CPU."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=8, top_k=min(moe.top_k, 2),
            d_ff_expert=64, d_ff_dense=128,
            first_dense_layers=min(moe.first_dense_layers, 1))
    mla = cfg.mla
    if mla is not None:
        mla = dataclasses.replace(mla, kv_lora_rank=32, qk_nope_dim=16,
                                  qk_rope_dim=8, v_head_dim=16)
    n_layers = min(cfg.n_layers, len(cfg.block_pattern) + 2
                   if cfg.block_pattern else 2)
    if cfg.block_pattern:
        n_layers = len(cfg.block_pattern) + 1  # one full pattern + remainder
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        mla=mla,
        rnn_width=64 if cfg.rnn_width else 0,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_patches=8 if cfg.n_patches else 0,
        rwkv_head_size=16,
        q_block=16,
        logit_chunk=32,
        accum_steps=1,
    )
    return dataclasses.replace(base, **overrides).validate()
