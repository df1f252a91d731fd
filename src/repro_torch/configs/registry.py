"""Architecture registry: the port's own copy of
``repro/configs/registry.py``, all ten entries as data.

Sources are public literature/HF configs; see per-entry comments.
Select with ``--arch <id>`` in the launchers.  Every entry is listed,
but only the ``dense`` and ``ssm`` families can be built into a model
yet (``models/lm.py::plan_segments`` raises for the others, naming
their ROADMAP item).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduced)

# ---------------------------------------------------------------------------
# Dense llama-family
# ---------------------------------------------------------------------------

GRANITE_20B = ModelConfig(                       # [arXiv:2405.04324; hf]
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,   # MQA
    d_ff=24576, vocab_size=49152, head_dim=128,
    accum_steps=8,
).validate()

GRANITE_3_2B = ModelConfig(      # [hf:ibm-granite/granite-3.0-2b-base]
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,   # GQA
    d_ff=8192, vocab_size=49155, head_dim=64,
    accum_steps=4,
).validate()

LLAMA3_2_1B = ModelConfig(         # [hf:meta-llama/Llama-3.2-1B; unverified]
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500000.0, tie_embeddings=True,
    accum_steps=4,
).validate()

QWEN2_72B = ModelConfig(                         # [arXiv:2407.10671; hf]
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True,                               # Qwen2 QKV bias
    rope_theta=1000000.0,
    accum_steps=8,   # microbatch 32 divides the multi-pod DP axes (2x16)
).validate()

# ---------------------------------------------------------------------------
# VLM — InternViT frontend is a STUB (precomputed patch embeddings);
# backbone is the InternLM2-76B decoder.          [arXiv:2404.16821]
# ---------------------------------------------------------------------------

INTERNVL2_76B = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    n_patches=256,
    accum_steps=8,   # microbatch 32 divides the multi-pod DP axes (2x16)
).validate()

# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

DEEPSEEK_V2_LITE_16B = ModelConfig(              # [arXiv:2405.04434; hf]
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408,                                    # routed-expert intermediate
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    # 64 routed experts top-6 + 2 shared (HF V2-Lite config; the
    # assignment's "160 routed" is full V2 — see DESIGN.md §7).
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_dense_layers=1, d_ff_dense=10944),
    accum_steps=8,
).validate()

OLMOE_1B_7B = ModelConfig(                       # [arXiv:2409.02060; hf]
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, n_shared=0, d_ff_expert=1024),
    accum_steps=4,
).validate()

# ---------------------------------------------------------------------------
# SSM / hybrid — sub-quadratic: these run long_500k
# ---------------------------------------------------------------------------

RWKV6_7B = ModelConfig(                          # [arXiv:2404.05892; hf]
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0,   # attn-free
    d_ff=14336, vocab_size=65536,
    rwkv_head_size=64,
    supports_long_context=True,
    accum_steps=8,
).validate()

RECURRENTGEMMA_2B = ModelConfig(                 # [arXiv:2402.19427; hf]
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,   # MQA local attn
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"),             # 1:2 attn:rglru
    local_window=2048, rnn_width=2560, conv_width=4,
    supports_long_context=True,
    accum_steps=4,
).validate()

# ---------------------------------------------------------------------------
# Audio enc-dec — conv frontend is a STUB (precomputed frame embeddings)
# ---------------------------------------------------------------------------

WHISPER_SMALL = ModelConfig(                     # [arXiv:2212.04356]
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    n_encoder_layers=12, encoder_seq_ratio=1.0,
    accum_steps=2,
).validate()


ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        GRANITE_20B, GRANITE_3_2B, LLAMA3_2_1B, QWEN2_72B, INTERNVL2_76B,
        DEEPSEEK_V2_LITE_16B, OLMOE_1B_7B, RWKV6_7B, RECURRENTGEMMA_2B,
        WHISPER_SMALL,
    )
}

ARCH_ORDER = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    return ARCHS[arch]


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
