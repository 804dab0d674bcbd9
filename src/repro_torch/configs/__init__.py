"""Config registry — the counterpart of ``repro.configs``.
``get_config("<arch-id>")`` lazy-imports and returns a ported
architecture; an assigned one that is not ported yet raises."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, UNPORTED,
                                      ArchConfig, InputShape, get_config,
                                      list_archs, register)

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "list_archs", "register", "ARCH_IDS", "UNPORTED"]
