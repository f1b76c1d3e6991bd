"""One typed configuration for the whole framework, JSON-serializable.

The port's copy of ``braintpu/utils/config.py``: the same dataclass tree, the
same keys, defaults and checks, and the same JSON bytes from
:func:`save_config`.  ``pipeline_config()`` projects onto the port's
``PipelineConfig``.  A config may name the ``axial`` model, as the
reference's; with the default fullconv mode the CLI then exits with the
reference's message (axial models run in sliding mode only).

The upstream project scatters its configuration across argparse flags in nine
scripts, nnU-Net env vars, a pickled plans file, and hard-coded constants
(SURVEY.md §5 "Config / flag system": run_full_pipeline.py:47-51,
run_brats2021_inference_singlethread.py:246-250, generic_UNet.py:172-186).
Here everything a run needs is a single dataclass tree that round-trips
through JSON, so pipelines are reproducible from one artifact.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = [
    "SegmentationSettings",
    "ReportSettings",
    "ServeSettings",
    "FrameworkConfig",
    "load_config",
    "save_config",
]


@dataclass
class SegmentationSettings:
    """Ensemble inference knobs (mirrors InferenceEngine + CLI defaults)."""

    models: List[str] = field(default_factory=lambda: ["model1", "model2"])
    folds: int = 5
    tta: bool = True
    step_size: float = 0.5
    ensemble: str = "softmax"  # "softmax" (canonical KAIST) | "label" (repo parity)
    # "fullconv" (whole-volume production mode, ~2.6x faster measured —
    # PERF.md round 3) | "sliding" (canonical bit-parity nnU-Net recipe)
    mode: str = "fullconv"
    et_min_voxels: int = 200
    output_convention: str = "brats2025"
    checkpoints: Optional[str] = None  # checkpoint root; None -> random init


@dataclass
class ReportSettings:
    use_llm_refinement: bool = False
    llm_model: str = "gemini-2.5-flash"
    generate_pdf: bool = True


@dataclass
class ServeSettings:
    host: str = "127.0.0.1"
    port: int = 8000
    sessions_root: str = "sessions"


@dataclass
class FrameworkConfig:
    segmentation: SegmentationSettings = field(default_factory=SegmentationSettings)
    report: ReportSettings = field(default_factory=ReportSettings)
    serve: ServeSettings = field(default_factory=ServeSettings)
    output_root: str = "results"
    evaluate_if_gt: bool = True
    fail_fast: bool = False

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FrameworkConfig":
        def build(klass, sub):
            known = {f.name: f for f in dataclasses.fields(klass)}
            unknown = set(sub) - set(known)
            if unknown:
                raise ValueError(
                    f"unknown {klass.__name__} keys: {sorted(unknown)}"
                )
            return klass(**sub)

        d = dict(d)
        out = {}
        for name, klass in (
            ("segmentation", SegmentationSettings),
            ("report", ReportSettings),
            ("serve", ServeSettings),
        ):
            if name in d:
                out[name] = build(klass, d.pop(name))
        return build(cls, {**d, **out})

    def validate(self) -> "FrameworkConfig":
        s = self.segmentation
        if s.ensemble not in ("softmax", "label"):
            raise ValueError(f"ensemble must be softmax|label, got {s.ensemble!r}")
        if s.mode not in ("sliding", "fullconv"):
            raise ValueError(f"mode must be sliding|fullconv, got {s.mode!r}")
        if s.output_convention not in ("brats2025", "brats2021", "internal"):
            raise ValueError(f"bad output_convention {s.output_convention!r}")
        if not 0 < s.step_size <= 1:
            raise ValueError(f"step_size must be in (0, 1], got {s.step_size}")
        if s.folds < 1:
            raise ValueError("folds must be >= 1")
        for m in s.models:
            if m not in ("model1", "model2", "axial"):
                raise ValueError(f"unknown model {m!r}")
        return self

    def pipeline_config(self):
        """Project onto the orchestrator's PipelineConfig."""
        from ..pipeline.orchestrator import PipelineConfig

        return PipelineConfig(
            output_root=Path(self.output_root),
            evaluate_if_gt=self.evaluate_if_gt,
            generate_pdf=self.report.generate_pdf,
            use_llm_refinement=self.report.use_llm_refinement,
            save_brats_convention=self.segmentation.output_convention,
            fail_fast=self.fail_fast,
        )


def load_config(path) -> FrameworkConfig:
    with open(path) as f:
        return FrameworkConfig.from_dict(json.load(f)).validate()


def save_config(cfg: FrameworkConfig, path) -> None:
    Path(path).write_text(json.dumps(cfg.to_dict(), indent=2) + "\n")
