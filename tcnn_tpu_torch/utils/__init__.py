"""Utilities: logging, profiling, batch samplers and serving-raster
positions, the host image sampler, image metrics, npz checkpoints."""

from .log import (
    LogSeverity,
    log,
    log_debug,
    log_error,
    log_info,
    log_success,
    log_warning,
    set_log_callback,
    set_verbose,
)

__all__ = [
    "LogSeverity",
    "log",
    "log_debug",
    "log_error",
    "log_info",
    "log_success",
    "log_warning",
    "set_log_callback",
    "set_verbose",
]
