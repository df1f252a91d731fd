"""Serving substrate: prefill/decode entry points + continuous batching
(port of ``repro.serve``)."""
from repro_torch.serve.engine import Request, ServingEngine, make_serve_fns

__all__ = ["Request", "ServingEngine", "make_serve_fns"]
