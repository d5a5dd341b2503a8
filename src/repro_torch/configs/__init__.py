from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_configs, register)

# import for registration side-effects
from repro_torch.configs import archs as _archs  # noqa: F401

__all__ = [
    "ArchConfig",
    "InputShape",
    "INPUT_SHAPES",
    "register",
    "get_config",
    "list_configs",
]
