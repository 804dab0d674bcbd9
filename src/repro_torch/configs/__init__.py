"""Config registry — the counterpart of ``repro.configs``.
``get_config("<arch-id>")`` lazy-imports and returns any of the ten
assigned architectures."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                      InputShape, get_config, list_archs,
                                      register)

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "list_archs", "register", "ARCH_IDS"]
