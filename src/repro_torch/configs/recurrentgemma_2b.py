"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import RECURRENTGEMMA_2B as CONFIG

__all__ = ["CONFIG"]
