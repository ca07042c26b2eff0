from repro_torch.configs.base import (
    ArchEntry,
    ModelConfig,
    get_config,
    register,
)

__all__ = ["ArchEntry", "ModelConfig", "get_config", "register"]
