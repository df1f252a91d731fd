"""K4, flash attention, as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the Pallas
TPU kernel).  The CUDA source is ``repro_torch/csrc/flash_attention.cu``,
built with ``nvcc`` at first use and called through ctypes
(``kernels/build.py``).  Its plain PyTorch version is
``models.attention.full_attention``.

``flash_attention`` takes tensors on one device:

  * CPU tensors go to the plain version (the tests, ``--device cpu``);
  * CUDA tensors launch the kernel on the current stream, and every
    launch adds one to ``LAUNCHES``.  A failed build or launch raises:
    nothing falls back to the plain version.

The kernel reads q, k and v through their strides (the head dim must be
contiguous), so the (B, S, H, D) projections of a model go in as
transposed views without a copy, and it writes the output into a
(B, Sq, Hq, D) buffer returned as its (B, Hq, Sq, D) view.  In bfloat16
the kernel loads its tiles by TMA, whose tensor maps take a 16-byte
aligned base and strides that are multiples of 16 bytes
(``tma_ready``); any other tensor is copied to a contiguous one first.
``PLAN`` is the bfloat16 kernel's tiling per head dim, which the C entry
checks against the one it was compiled with.  ``window`` is the sliding
window of local attention (``full_attention``'s ``local_window``): the
Pallas kernel has none; this one bounds its key loop by it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.models.attention import full_attention

#: Kernel launches since the last reset (``LAUNCHES = 0``).
LAUNCHES = 0

#: Head dims the kernel takes, per dtype (float32 stops at 128).
HEAD_DIMS = {torch.float32: (32, 64, 128),
             torch.bfloat16: (32, 64, 128, 256)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The bfloat16 kernel's tiling per head dim (``WgPlan`` in the CUDA
#: source): key-tile rows and K/V ring stages.  A block takes 128 query
#: rows.
PLAN = {32: (128, 3), 64: (128, 3), 128: (128, 2), 256: (64, 2)}
BLOCK_Q = 128
#: Dynamic shared memory a block may use on an H100 (227 KB).
SMEM_LIMIT = 232448

_FN = None


def smem_bytes(d: int) -> int:
    """Shared memory of a bfloat16 block at head dim ``d``: the Q tile,
    ``stages`` K and V tiles, 1024 bytes to align them to the swizzle
    atom and 256 for the barriers."""
    block_n, stages = PLAN[d]
    return 1024 + BLOCK_Q * d * 2 + 2 * stages * block_n * d * 2 + 256


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` in place: its last dim is
    contiguous, its base 16-byte aligned, and each other stride a
    multiple of 16 bytes, nonzero where the dim has more than one entry
    (what a TMA tensor map takes)."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if ``tma_ready``, else a contiguous copy."""
    return t if tma_ready(t) else t.contiguous()


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> None:
    """Raise for shapes, dtypes or head dims the kernel refuses."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"fit k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; expected one of float32, bfloat16")
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS[q.dtype]} for {q.dtype}")


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int, scale: Optional[float]):
    """The output buffer and the C entry's arguments but the stream, for
    q, k, v that pass ``check_inputs`` and ``tma_ready``."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    block_n, stages = PLAN[d] if q.dtype == torch.bfloat16 else (0, 0)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return out, (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, strides, block_n,
                 stages, scale, int(causal or window > 0), int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0; one dtype,
    float32 or bfloat16.  Causal masks key positions past the query's
    (both counted from 0); ``window`` W > 0 also masks keys at or before
    ``q_pos - W`` and implies causal.  Returns (B, Hq, Sq, D) in q's
    dtype."""
    global LAUNCHES
    refuse_autograd("flash_attention", q, k, v)
    dev = q.device
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if dev.type == "cpu":
        return full_attention(q, k, v, causal=causal, local_window=window,
                              scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    check_inputs(q, k, v)
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)   # alive past launch
    out, args = launch_args(q, k, v, causal=causal, window=window,
                            scale=scale)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
