"""Generic decoder LM: embeddings + block segments + unembedding.

Port of ``repro/models/lm.py`` for serving (prefill and decode) and
training (``train_loss``) of the ``dense`` (llama), ``vlm`` (InternVL2's
decoder), ``moe`` (OLMoE, DeepSeek-V2), ``ssm`` (RWKV6) and ``hybrid``
(RecurrentGemma) families; ``encdec`` (Whisper) is ``models/encdec.py``.
Training runs the plain paths under autograd, as the reference
differentiates its plain JAX paths (no kernel has a backward), and
takes either an ``LM`` or the reference's flat parameter dict
(``flat_weights``).

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

The moe family is DeepSeek's ``dense_mla`` layers (``first_dense_layers``,
unscanned, ``seg0.l{j}``), then one scanned ``moe`` segment.  The vlm
family is one dense segment behind a stub vision front end: precomputed
patch embeddings (B, P, d), projected by ``patch_proj`` and prepended to
the token embeddings outside decode, so positions run over P + S and a
decode index counts the P patch positions.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks_attn, blocks_moe, blocks_rnn
from repro_torch.models.common import (ParamTable, Params, TableModel,
                                       TableModule, chunked_softmax_xent,
                                       embed, matmul, merge_tables,
                                       prefix_table, rms_norm, stack_table,
                                       unembed)

#: ``seg{i}.l{j}`` -> the layer's cache: ``{name: tensor}``, or for a
#: pattern layer ``{"p{k}": {name: tensor}}``.
Caches = Dict[str, Dict[str, Any]]
#: Per-segment lists of per-layer ``{name: tensor}`` dicts (the block
#: tables' names).
Layers = List[List[Params]]
Aux = Dict[str, torch.Tensor]


class Segment(NamedTuple):
    kind: str
    n: int
    scanned: bool


def plan_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("dense", cfg.n_layers, cfg.use_scan)]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        segs = [Segment("dense_mla", fd, False)] if fd else []
        return segs + [Segment("moe", cfg.n_layers - fd, cfg.use_scan)]
    if cfg.family == "ssm":
        return [Segment("rwkv", cfg.n_layers, cfg.use_scan)]
    if cfg.family == "hybrid":
        reps, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
        segs = [Segment("pattern", reps, cfg.use_scan)]
        for k in range(rem):  # remainder layers follow the pattern order
            segs.append(Segment(cfg.block_pattern[k], 1, False))
        return segs
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not handled "
                     f"by lm.py")


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
    aux: Aux = {}
    for j, kind in enumerate(cfg.block_pattern):
        pre = f"p{j}."
        sub = {k[len(pre):]: v for k, v in params.items()
               if k.startswith(pre)}
        x, new_cache[f"p{j}"], a = BLOCKS[kind][1](
            cfg, sub, x, mode=mode,
            cache=cache[f"p{j}"] if mode == "decode" else None,
            positions=positions, index=index, backend=backend)
        for k, v in a.items():
            aux[k] = aux.get(k, 0.0) + v
    return x, (None if mode == "train" else new_cache), aux


def _pattern_cache(cfg, batch, seq, dtype, device):
    return {f"p{j}": BLOCKS[kind][2](cfg, batch, seq, dtype, device)
            for j, kind in enumerate(cfg.block_pattern)}


BLOCKS: Dict[str, Tuple[Any, Any, Any]] = {
    "dense": (blocks_attn.table, blocks_attn.apply, blocks_attn.init_cache),
    "moe": (blocks_moe.table, blocks_moe.apply, blocks_moe.init_cache),
    "dense_mla": (blocks_moe.dense_mla_table, blocks_moe.dense_mla_apply,
                  blocks_moe.init_cache),
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
    if cfg.family == "vlm":
        # stub front end: a projection of precomputed patch embeddings
        top["patch_proj"] = ((cfg.d_model, cfg.d_model), ("d_model", None))
    return top


def param_table(cfg: ModelConfig) -> ParamTable:
    tabs = [_top_table(cfg)]
    for i, seg in enumerate(plan_segments(cfg)):
        tab = BLOCKS[seg.kind][0](cfg)
        if seg.scanned:
            tabs.append(prefix_table(f"seg{i}", stack_table(tab, seg.n)))
        else:
            for j in range(seg.n):
                tabs.append(prefix_table(f"seg{i}.l{j}", tab))
    return merge_tables(*tabs)


class LM(TableModel):
    """The model's parameters: ``top`` (embed, final_norm, unembed, the
    vlm's patch_proj) and ``segs[i][j]``, layer j of segment i, each a
    ``TableModule`` named by the block's table.  Allocated uninitialized
    on ``device``; fill with ``init_weights`` or
    ``convert.params_from_numpy``."""

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

    def table_entries(self) -> Iterator[Tuple[str, Tuple[int, ...],
                                              List[torch.Tensor]]]:
        table = param_table(self.cfg)
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

    def weights(self) -> Tuple[Params, Layers]:
        """(the top tensors, per-segment lists of per-layer dicts)."""
        return self.top.params(), [[layer.params() for layer in seg]
                                   for seg in self.segs]


#: The family's model class, as ``api.model_class`` finds it.
Model = LM


def flat_weights(cfg: ModelConfig, params: Params) -> Tuple[Params, Layers]:
    """``LM.weights``'s layout from the reference's flat dict (stacked
    entries of scanned segments on a leading layer axis): a scanned
    layer's tensors are views of the stacked ones (``unbind``), so a
    gradient reaches the stacked tensor."""
    top = {k: params[k] for k in _top_table(cfg)}
    layers: Layers = []
    for i, seg in enumerate(plan_segments(cfg)):
        keys = list(BLOCKS[seg.kind][0](cfg))
        if seg.scanned:
            per = {key: params[f"seg{i}.{key}"].unbind(0) for key in keys}
            layers.append([{key: per[key][j] for key in keys}
                           for j in range(seg.n)])
        else:
            layers.append([{key: params[f"seg{i}.l{j}.{key}"]
                            for key in keys} for j in range(seg.n)])
    return top, layers


def weights(cfg: ModelConfig, params) -> Tuple[Params, Layers]:
    """``params``, an ``LM`` or the reference's flat dict, as (top,
    layers)."""
    if isinstance(params, LM):
        return params.weights()
    return flat_weights(cfg, params)


# ----------------------------------------------------------------------
# Forward pass over segments
# ----------------------------------------------------------------------

def run_blocks(cfg: ModelConfig, layers: Layers, x: torch.Tensor, *,
               mode: str, caches: Optional[Caches], positions: torch.Tensor,
               index: Optional[int] = None, backend: str = "cuda"
               ) -> Tuple[torch.Tensor, Caches, Aux]:
    """Every layer in order.  Prefill returns fresh per-layer caches;
    decode updates ``caches`` in place and returns it.  Train returns no
    caches and each aux term summed over layers; it runs the plain paths
    (the kernels have no backward), each layer under
    ``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
    ``jax.checkpoint(nothing_saveable)``: only the layer's input is
    kept, the rest recomputed in the backward)."""
    new_caches: Caches = {}
    aux_total: Aux = {}
    train = mode == "train"
    for i, seg in enumerate(plan_segments(cfg)):
        apply_fn = BLOCKS[seg.kind][1]
        for j, params in enumerate(layers[i]):
            key = f"seg{i}.l{j}"
            kw = dict(mode=mode, positions=positions, index=index,
                      cache=caches[key] if mode == "decode" else None,
                      backend="reference" if train else backend)
            if train and cfg.remat:
                x, c_out, aux = checkpoint(apply_fn, cfg, params, x,
                                           use_reentrant=False, **kw)
            else:
                x, c_out, aux = apply_fn(cfg, params, x, **kw)
            if train:
                for k, v in aux.items():
                    aux_total[k] = aux_total.get(k, 0.0) + v
            else:
                new_caches[key] = c_out
    return x, (None if train else new_caches), aux_total


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

def embed_inputs(cfg: ModelConfig, top: Params, batch: Dict[str, Any], *,
                 mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, d), positions (B, S)).  Decode positions are the
    batch's uniform ``index``.  vlm: ``batch["patches"]`` (B, P, d), cast
    to the embedding dtype and projected, go before the tokens (in
    prefill and train)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = embed(tokens, top["embed"])
    if cfg.family == "vlm" and mode != "decode":
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([matmul(patches, top["patch_proj"]), x], dim=1)
    if mode == "decode":
        positions = torch.full((b, 1), int(batch["index"]),
                               dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(b, -1)
    return x, positions


def _unembed_weight(cfg: ModelConfig, top: Params) -> torch.Tensor:
    return top["embed"] if cfg.tie_embeddings else top["unembed"]


def _logits(cfg: ModelConfig, top: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, top["final_norm.scale"], cfg.norm_eps)
    return unembed(x, _unembed_weight(cfg, top)).float()


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Aux]:
    """The reference's ``lm.train_loss``: ``params`` an ``LM`` or the
    reference's flat dict; ``batch`` {"tokens", "labels", "mask"} (B, S)
    (and the vlm's "patches" (B, P, d)).  Returns (total loss, metrics):
    ``xent`` (the vlm's on its text positions only), every aux term
    summed over layers (``moe_aux``, ``moe_z``, ``moe_dropped``), and
    ``loss`` = xent + moe_aux + moe_z."""
    top, layers = weights(cfg, params)
    x, positions = embed_inputs(cfg, top, batch, mode="train")
    x, _, aux = run_blocks(cfg, layers, x, mode="train", caches=None,
                           positions=positions)
    x = rms_norm(x, top["final_norm.scale"], cfg.norm_eps)
    if cfg.family == "vlm":     # loss only on the text positions
        x = x[:, batch["patches"].shape[1]:]
    loss = chunked_softmax_xent(x, batch["labels"], _unembed_weight(cfg, top),
                                batch["mask"], cfg.logit_chunk)
    total = loss
    metrics = {"xent": loss}
    for k, v in aux.items():
        metrics[k] = v
        if k in ("moe_aux", "moe_z"):
            total = total + v
    metrics["loss"] = total
    return total, metrics


def prefill(cfg: ModelConfig, model, batch: Dict[str, Any],
            backend: str = "cuda") -> Tuple[torch.Tensor, Caches]:
    """Process the full prompt; return (last-position logits (B, 1, V)
    f32, per-layer caches).  ``model``: an ``LM`` or the reference's flat
    dict."""
    top, layers = weights(cfg, model)
    x, positions = embed_inputs(cfg, top, batch, mode="prefill")
    x, caches, _ = run_blocks(cfg, layers, x, mode="prefill", caches=None,
                              positions=positions, backend=backend)
    return _logits(cfg, top, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, model, caches: Caches,
                batch: Dict[str, Any], backend: str = "cuda"
                ) -> Tuple[torch.Tensor, Caches]:
    """One token for every sequence in the batch.

    ``batch`` = {"tokens": (B, 1), "index": int position}.  The caches
    are written in place.  ``model``: an ``LM`` or the reference's flat
    dict."""
    top, layers = weights(cfg, model)
    x, positions = embed_inputs(cfg, top, batch, mode="decode")
    x, caches, _ = run_blocks(cfg, layers, x, mode="decode", caches=caches,
                              positions=positions, index=int(batch["index"]),
                              backend=backend)
    return _logits(cfg, top, x), caches
