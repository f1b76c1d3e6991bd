"""Radiology feature extraction: the reference's 6-step pipeline on a shared context.

The port's copy of ``braintpu/features``: the host route in numpy and scipy,
and the device-batched statistics of :mod:`.devstats` in PyTorch, routed per
kernel group by ``BRAINTPU_DEVICE_FEATURES`` (``auto`` takes the groups
measured to win on the H100, and only for a context on a CUDA card).
"""

from .context import (
    FeatureContext,
    NumpyJSONEncoder,
    brain_mask_from,
    intensity_stats,
    save_json,
    tumor_masks_from_seg,
)
from .runner import compile_comprehensive_report, generate_llm_summary, run_all_steps
from .step1_signals import analyze_sequence_findings, signal_label
from .step2_mass_effect import analyze_mass_effect
from .step3_multiplicity import analyze_multiplicity
from .step4_morphology import analyze_morphology
from .step5_quality import analyze_quality
from .step6_normal_structures import analyze_normal_structures, identify_ventricles

__all__ = [
    "FeatureContext",
    "NumpyJSONEncoder",
    "brain_mask_from",
    "intensity_stats",
    "save_json",
    "tumor_masks_from_seg",
    "compile_comprehensive_report",
    "generate_llm_summary",
    "run_all_steps",
    "analyze_sequence_findings",
    "signal_label",
    "analyze_mass_effect",
    "analyze_multiplicity",
    "analyze_morphology",
    "analyze_quality",
    "analyze_normal_structures",
    "identify_ventricles",
]
