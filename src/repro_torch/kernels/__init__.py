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
