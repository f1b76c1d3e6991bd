"""Single-process pipeline orchestration with structured progress events.

The port's copy of ``braintpu/pipeline``: the same stages, events journal and
one-case lookahead, around the port's fullconv ``InferenceEngine``.
"""

from .orchestrator import STAGES, Pipeline, PipelineConfig, PipelineResult, StageEvent

__all__ = ["STAGES", "Pipeline", "PipelineConfig", "PipelineResult", "StageEvent"]
