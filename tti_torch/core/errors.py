"""Exception hierarchy (copy of ``tti.core.errors``)."""


class TtiError(Exception):
    """Base class for all framework errors."""


class ConfigError(TtiError):
    """Invalid or missing configuration."""


class CalibrationError(TtiError):
    """Intrinsics/extrinsics missing or calibration failed."""


class InferenceError(TtiError):
    """Model load / forward / postprocess failure."""


class ServiceError(TtiError):
    """Side-channel service (serial / db / mqtt / cleaner) failure."""
