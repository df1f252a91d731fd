"""Device selection shared by every entry point of the port.

Entry points default to ``cuda``; the CPU runs only when the caller asks
for it.  A ``cuda`` request on a machine without a card raises instead of
silently falling back to the host.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent.  On CUDA it also pins float32 matmuls and convolutions to
    full precision (no TF32), so sums of small integers stay exact."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                f"device; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev
