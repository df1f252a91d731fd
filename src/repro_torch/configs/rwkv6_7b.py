"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import RWKV6_7B as CONFIG

__all__ = ["CONFIG"]
