"""Dataclass configs of the PyTorch port (own copy of
``adaptive_sd_tpu/config``)."""

from .base import ENV_PREFIX, BaseConfig, ConfigManager
from .schemas import (
    CacheConfig,
    CascadeConfig,
    DataGenerationConfig,
    LoggingConfig,
    MonitoringConfig,
    OptimizationConfig,
    PredictorTrainingConfig,
    QualityConfig,
    SecurityConfig,
    ServerConfig,
    ServingConfig,
    StageConfig,
    SystemConfig,
    TrainingConfig,
)

__all__ = [name for name in dir() if not name.startswith("_")]
