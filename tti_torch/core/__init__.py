"""Configuration, errors and logging; exports the names ``tti.core`` does."""

from tti_torch.core.config import (
    AppConfig,
    BoardConfig,
    CameraConfig,
    DatabaseConfig,
    MeasureConfig,
    ModelConfig,
    MqttConfig,
    RoiConfig,
    RuntimeConfig,
    SerialConfig,
    ValidationConfig,
    load_config,
)
from tti_torch.core.errors import CalibrationError, ConfigError, InferenceError, TtiError
from tti_torch.core.logging import get_logger

__all__ = [
    "AppConfig",
    "BoardConfig",
    "CameraConfig",
    "DatabaseConfig",
    "MeasureConfig",
    "ModelConfig",
    "MqttConfig",
    "RoiConfig",
    "RuntimeConfig",
    "SerialConfig",
    "ValidationConfig",
    "load_config",
    "CalibrationError",
    "ConfigError",
    "InferenceError",
    "TtiError",
    "get_logger",
]
