from repro_torch.configs.base import (
    SHAPES,
    ArchEntry,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    list_archs,
    register,
)

__all__ = ["SHAPES", "ArchEntry", "ModelConfig", "ShapeConfig", "applicable_shapes",
           "get_config", "list_archs", "register"]
