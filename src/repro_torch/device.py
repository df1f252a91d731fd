"""Device selection shared by every entry point of the port.

Entry points default to ``cuda``; the CPU runs only when the caller asks
for it.  A ``cuda`` request on a machine without a card raises instead of
silently falling back to the host.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent, or a card index past the last card.  On CUDA it also pins
    float32 matmuls and convolutions to full precision (no TF32), so sums
    of small integers stay exact."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                f"device; pass device='cpu' to run on the host")
        n = torch.cuda.device_count()
        if dev.index is not None and dev.index >= n:
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees {n} CUDA "
                f"device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def upload(x, device: torch.device,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of host array or tensor ``x`` on ``device``.  To a card it
    goes through pinned memory without blocking the host, so uploading
    between two launches never waits for the device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)
