"""Host utilities of the port: environment checks, the framework config,
the device rule, ``.env`` loading."""

from .envcheck import format_env_report, run_env_checks

__all__ = ["format_env_report", "run_env_checks"]
