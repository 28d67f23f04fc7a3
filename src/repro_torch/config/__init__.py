from repro_torch.config.base import (
    FAMILIES,
    SALS_125,
    SALS_25,
    ModelConfig,
    SALSConfig,
    ServeConfig,
    asdict,
)

__all__ = ["FAMILIES", "SALS_125", "SALS_25", "ModelConfig", "SALSConfig",
           "ServeConfig", "asdict"]
