"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import DEEPSEEK_V2_LITE_16B as CONFIG

__all__ = ["CONFIG"]
