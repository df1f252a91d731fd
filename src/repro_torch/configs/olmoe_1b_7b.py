"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import OLMOE_1B_7B as CONFIG

__all__ = ["CONFIG"]
