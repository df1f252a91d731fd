"""Model configs: the port's own copies of ``repro.configs.base``,
``repro.configs.registry`` and ``repro.configs.shapes``."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduced)
from repro_torch.configs.registry import (ARCHS, ARCH_ORDER, get_config,
                                          get_smoke_config)
from repro_torch.configs.shapes import (SHAPES, SHAPE_ORDER, ShapeCell,
                                        cell_applicable)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "reduced", "ARCHS",
           "ARCH_ORDER", "get_config", "get_smoke_config", "SHAPES",
           "SHAPE_ORDER", "ShapeCell", "cell_applicable"]
