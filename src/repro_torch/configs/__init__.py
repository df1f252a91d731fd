"""Model configs: the port's own copies of ``repro.configs.base`` and
``repro.configs.registry``."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduced)
from repro_torch.configs.registry import (ARCHS, ARCH_ORDER, get_config,
                                          get_smoke_config)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "reduced", "ARCHS",
           "ARCH_ORDER", "get_config", "get_smoke_config"]
