"""Host utilities of the port: environment checks, the framework config,
the device rule, ``.env`` loading, profiling and tracing."""

from .envcheck import format_env_report, run_env_checks
from .profiling import StageTimer, device_trace, timed_device

__all__ = [
    "format_env_report",
    "run_env_checks",
    "StageTimer",
    "device_trace",
    "timed_device",
]
