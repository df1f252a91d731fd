"""Config module for --arch (see registry for the source entry)."""
from repro_torch.configs.registry import WHISPER_SMALL as CONFIG

__all__ = ["CONFIG"]
