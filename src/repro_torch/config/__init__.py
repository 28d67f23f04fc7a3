from repro_torch.config.base import (
    FAMILIES,
    SALS_125,
    SALS_25,
    SHAPES,
    MeshConfig,
    ModelConfig,
    SALSConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
    asdict,
)

__all__ = ["FAMILIES", "SALS_125", "SALS_25", "SHAPES", "MeshConfig",
           "ModelConfig", "SALSConfig", "ServeConfig", "ShapeConfig",
           "TrainConfig", "asdict"]
