"""Serving layer: REST API + job store + built-in web UI (stdlib only).

The port's copy of ``braintpu/serve``: each job runs the port's
``Pipeline`` on the engine's device (the card unless the engine was built
with ``device="cpu"``).
"""

from .api import BLOCKED_KEYWORDS, CLINICAL_REFUSAL, AnalysisServer, make_server
from .jobs import STAGE_PROGRESS, JobStore

__all__ = [
    "BLOCKED_KEYWORDS",
    "CLINICAL_REFUSAL",
    "AnalysisServer",
    "make_server",
    "STAGE_PROGRESS",
    "JobStore",
]
