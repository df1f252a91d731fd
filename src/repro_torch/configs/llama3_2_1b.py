"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import LLAMA3_2_1B as CONFIG

__all__ = ["CONFIG"]
