"""Assigned input-shape cells (identical for every LM-family arch): the
port's own copy of ``repro/configs/shapes.py``.

``decode_*`` / ``long_*`` run ``api.decode_step`` (one new token against
a KV cache of ``seq_len``); the others run the train step / ``prefill``.
``long_500k`` requires sub-quadratic attention and is skipped (recorded,
not run) for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_applicable(shape_name: str, supports_long_context: bool) -> bool:
    if shape_name == "long_500k":
        return supports_long_context
    return True
