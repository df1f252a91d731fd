"""Generic decoder LM: embeddings + block segments + unembedding.

Port of ``repro/models/lm.py`` for serving (prefill and decode) of the
``dense`` (llama), ``ssm`` (RWKV6) and ``hybrid`` (RecurrentGemma)
families; the others raise when a model is built (ROADMAP A11).

A model is a list of *segments*; each segment is ``n`` layers of one
block kind.  The reference stacks a scanned segment's parameters on a
leading layer axis (``seg0.attn.wq`` is (L, d, H, D)); here ``LM`` holds
one ``TableModule`` per layer, whose ``attn.wq`` is layer j's slice, and
layers run in a Python loop.  ``LM.table_entries`` maps the reference's
names onto the per-layer parameters (``convert`` carries weights across
with it).  Cache keys are ``seg{i}.l{j}``, as in the reference.

The hybrid family is RecurrentGemma's: ``pattern`` (rglru, rglru,
local) repeated ``n_layers // 3`` times as one scanned segment, whose
layer j holds the three blocks' parameters under ``p0.``, ``p1.``,
``p2.`` and its caches under ``p0``..``p2``, then the remainder layers
in pattern order, one unscanned segment each.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks_attn, blocks_rnn
from repro_torch.models.common import (ParamTable, TableModule, embed,
                                       init_rule, init_tensor_,
                                       merge_tables, prefix_table, rms_norm,
                                       stack_table, unembed)

#: ``seg{i}.l{j}`` -> the layer's cache: ``{name: tensor}``, or for a
#: pattern layer ``{"p{k}": {name: tensor}}``.
Caches = Dict[str, Dict[str, Any]]


class Segment(NamedTuple):
    kind: str
    n: int
    scanned: bool


def plan_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family == "dense":
        return [Segment("dense", cfg.n_layers, cfg.use_scan)]
    if cfg.family == "ssm":
        return [Segment("rwkv", cfg.n_layers, cfg.use_scan)]
    if cfg.family == "hybrid":
        reps, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
        segs = [Segment("pattern", reps, cfg.use_scan)]
        for k in range(rem):  # remainder layers follow the pattern order
            segs.append(Segment(cfg.block_pattern[k], 1, False))
        return segs
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
        f"yet (ROADMAP A11); ported: dense, ssm, hybrid")


# ----------------------------------------------------------------------
# Block registry
# ----------------------------------------------------------------------

def _local_apply(cfg, params, x, *, mode, cache, positions, index=None,
                 backend="cuda"):
    return blocks_attn.apply(cfg, params, x, mode=mode, cache=cache,
                             positions=positions, index=index,
                             local_window=cfg.local_window, backend=backend)


def _local_cache(cfg, batch, seq, dtype, device):
    return blocks_attn.init_attn_cache(cfg, batch, seq, dtype, device)


def _pattern_table(cfg: ModelConfig) -> ParamTable:
    return merge_tables(*(prefix_table(f"p{j}", BLOCKS[kind][0](cfg))
                          for j, kind in enumerate(cfg.block_pattern)))


def _pattern_apply(cfg, params, x, *, mode, cache, positions, index=None,
                   backend="cuda"):
    new_cache = {}
    for j, kind in enumerate(cfg.block_pattern):
        pre = f"p{j}."
        sub = {k[len(pre):]: v for k, v in params.items()
               if k.startswith(pre)}
        x, new_cache[f"p{j}"], _ = BLOCKS[kind][1](
            cfg, sub, x, mode=mode,
            cache=cache[f"p{j}"] if mode == "decode" else None,
            positions=positions, index=index, backend=backend)
    return x, new_cache, {}


def _pattern_cache(cfg, batch, seq, dtype, device):
    return {f"p{j}": BLOCKS[kind][2](cfg, batch, seq, dtype, device)
            for j, kind in enumerate(cfg.block_pattern)}


BLOCKS: Dict[str, Tuple[Any, Any, Any]] = {
    "dense": (blocks_attn.table, blocks_attn.apply, blocks_attn.init_cache),
    "rwkv": (blocks_rnn.table, blocks_rnn.apply, blocks_rnn.init_cache),
    "rglru": (blocks_rnn.rglru_table, blocks_rnn.rglru_block_apply,
              blocks_rnn.init_cache_rglru),
    "local": (blocks_attn.table, _local_apply, _local_cache),
}
BLOCKS["pattern"] = (_pattern_table, _pattern_apply, _pattern_cache)


# ----------------------------------------------------------------------
# Whole-model param table
# ----------------------------------------------------------------------

def _top_table(cfg: ModelConfig) -> ParamTable:
    top = {
        "embed": ((cfg.vocab_size, cfg.d_model), ("vocab", "d_model")),
        "final_norm.scale": ((cfg.d_model,), (None,)),
    }
    if not cfg.tie_embeddings:
        top["unembed"] = ((cfg.vocab_size, cfg.d_model),
                          ("vocab", "d_model"))
    return top


def lm_table(cfg: ModelConfig) -> ParamTable:
    tabs = [_top_table(cfg)]
    for i, seg in enumerate(plan_segments(cfg)):
        tab = BLOCKS[seg.kind][0](cfg)
        if seg.scanned:
            tabs.append(prefix_table(f"seg{i}", stack_table(tab, seg.n)))
        else:
            for j in range(seg.n):
                tabs.append(prefix_table(f"seg{i}.l{j}", tab))
    return merge_tables(*tabs)


class LM(nn.Module):
    """The model's parameters: ``top`` (embed, final_norm, unembed) and
    ``segs[i][j]``, layer j of segment i, each a ``TableModule`` named by
    the block's table.  Allocated uninitialized on ``device``; fill with
    ``init_weights`` or ``convert.params_from_numpy``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.plan = plan_segments(cfg)
        self.top = TableModule(
            {k: shape for k, (shape, _) in _top_table(cfg).items()},
            dtype, dev)
        self.segs = nn.ModuleList()
        for seg in self.plan:
            shapes = {k: shape
                      for k, (shape, _) in BLOCKS[seg.kind][0](cfg).items()}
            self.segs.append(nn.ModuleList(
                TableModule(shapes, dtype, dev) for _ in range(seg.n)))

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.top.embed.dtype

    def table_entries(self) -> Iterator[Tuple[str, Tuple[int, ...],
                                              List[torch.Tensor]]]:
        """``(reference name, reference shape, per-layer tensors)`` for
        every entry of ``lm_table``: a scanned entry lists one tensor per
        layer (the slices of its leading axis), any other entry one."""
        table = lm_table(self.cfg)
        for name in _top_table(self.cfg):
            yield name, table[name][0], [self.top.get_parameter(name)]
        for i, seg in enumerate(self.plan):
            for key in BLOCKS[seg.kind][0](self.cfg):
                if seg.scanned:
                    name = f"seg{i}.{key}"
                    yield name, table[name][0], [
                        layer.get_parameter(key) for layer in self.segs[i]]
                else:
                    for j, layer in enumerate(self.segs[i]):
                        name = f"seg{i}.l{j}.{key}"
                        yield name, table[name][0], [
                            layer.get_parameter(key)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     scale: float = 0.02) -> "LM":
        """The reference's init rules (``common.init_rule``, with the
        fan-in of the reference's stacked shape), drawn from
        ``generator`` (on this model's device) in sorted name order."""
        for name, shape, tensors in sorted(self.table_entries(),
                                           key=lambda e: e[0]):
            rule = init_rule(name, shape, scale)
            for t in tensors:
                init_tensor_(t, rule, generator)
        return self


# ----------------------------------------------------------------------
# Forward pass over segments
# ----------------------------------------------------------------------

def run_blocks(cfg: ModelConfig, model: LM, x: torch.Tensor, *, mode: str,
               caches: Optional[Caches], positions: torch.Tensor,
               index: Optional[int] = None, backend: str = "cuda"
               ) -> Tuple[torch.Tensor, Caches]:
    """Every layer in order.  Prefill returns fresh per-layer caches;
    decode updates ``caches`` in place and returns it."""
    new_caches: Caches = {}
    for i, seg in enumerate(model.plan):
        apply_fn = BLOCKS[seg.kind][1]
        for j, layer in enumerate(model.segs[i]):
            key = f"seg{i}.l{j}"
            x, c_out, _ = apply_fn(
                cfg, layer.params(), x, mode=mode,
                cache=caches[key] if mode == "decode" else None,
                positions=positions, index=index, backend=backend)
            new_caches[key] = c_out
    return x, new_caches


def init_caches(cfg: ModelConfig, batch: int, seq: int,
                dtype: torch.dtype, device: torch.device) -> Caches:
    """Per-layer cache layout (matches decode and prefill's output)."""
    caches: Caches = {}
    for i, seg in enumerate(plan_segments(cfg)):
        cache_fn = BLOCKS[seg.kind][2]
        for j in range(seg.n):
            caches[f"seg{i}.l{j}"] = cache_fn(cfg, batch, seq, dtype, device)
    return caches


# ----------------------------------------------------------------------
# Embedding front end
# ----------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, model: LM, batch: Dict[str, Any], *,
                 mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, d), positions (B, S)).  Decode positions are the
    batch's uniform ``index``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(tokens, model.top.embed)
    if mode == "decode":
        positions = torch.full((b, 1), int(batch["index"]),
                               dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    return x, positions


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.top.final_norm.scale, cfg.norm_eps)
    w = model.top.embed if cfg.tie_embeddings else model.top.unembed
    return unembed(x, w).float()


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def prefill(cfg: ModelConfig, model: LM, batch: Dict[str, Any],
            backend: str = "cuda") -> Tuple[torch.Tensor, Caches]:
    """Process the full prompt; return (last-position logits (B, 1, V)
    f32, per-layer caches)."""
    x, positions = embed_inputs(cfg, model, batch, mode="prefill")
    x, caches = run_blocks(cfg, model, x, mode="prefill", caches=None,
                           positions=positions, backend=backend)
    return _logits(cfg, model, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, model: LM, caches: Caches,
                batch: Dict[str, Any], backend: str = "cuda"
                ) -> Tuple[torch.Tensor, Caches]:
    """One token for every sequence in the batch.

    ``batch`` = {"tokens": (B, 1), "index": int position}.  The caches
    are written in place."""
    x, positions = embed_inputs(cfg, model, batch, mode="decode")
    x, caches = run_blocks(cfg, model, x, mode="decode", caches=caches,
                           positions=positions, index=int(batch["index"]),
                           backend=backend)
    return _logits(cfg, model, x), caches
