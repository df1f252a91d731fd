"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``)."""
import torch


def refuse_autograd(entry: str, *tensors) -> None:
    """Raise if autograd would record through ``entry``: grad mode is on
    and an input requires a gradient.  No kernel has a backward, so its
    output would be cut off from the graph and every gradient behind it
    silently zero.  Training runs the plain versions
    (``backend="reference"``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry}: the kernel has no backward, and an input requires "
            f"a gradient; train on the plain version (backend='reference')"
            f" or call it under torch.no_grad()/inference_mode()")


def address(t: torch.Tensor) -> int:
    """``t``'s data address, for the alignment rules of the wrappers: on
    meta (no data) its offset into a storage taken to start aligned, as
    every fresh allocation of the caching allocator does."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def check_arg(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
              device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` and ``shape``
    and is contiguous: what a wrapper checks of each input before it
    hands the kernel a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
