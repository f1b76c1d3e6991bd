"""Fact extraction: model outputs → structured facts (deterministic, no LLM).

Reproduces the reference's ``FactExtractor``
(upstream report_templates.py:655-894): the ~35 derived facts with
identical thresholds — edema degree bins at 5/15/30 cm³ absolute volume,
necrosis ratio bins at 1/10/30 %, midline-shift significance at 2.0 mm,
mm→cm size rounded to the nearest 0.5.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["extract_facts", "MIDLINE_SHIFT_THRESHOLD_MM", "NECROSIS_THRESHOLDS"]

MIDLINE_SHIFT_THRESHOLD_MM = 2.0

NECROSIS_THRESHOLDS = {
    "none": (0, 0.01),
    "minimal": (0.01, 0.10),
    "moderate": (0.10, 0.30),
    "extensive": (0.30, 1.0),
}


def _distribution(multiplicity: Dict) -> str:
    count = multiplicity.get("lesion_count", 1)
    pattern = multiplicity.get("distribution_pattern", "").lower()
    if count == 1:
        return "focal"
    if "distant" in pattern or "multicentric" in pattern:
        return "multifocal or multicentric"
    return "multifocal"


def _lobes_formatted(location: Dict) -> str:
    lobes = location.get("involved_lobes", [])
    hemisphere = location.get("hemisphere", "")
    if not lobes:
        return f"{hemisphere} {location.get('primary_lobe', 'unknown')} lobe"
    if len(lobes) == 1:
        return f"{hemisphere} {lobes[0]} lobe"
    if len(lobes) == 2:
        return f"{hemisphere} {lobes[0]} and {lobes[1]} lobes"
    return f"{hemisphere} {', '.join(lobes[:-1])}, and {lobes[-1]} lobes"


def _depth_prefix(location: Dict) -> str:
    depth = location.get("depth", "").lower()
    if "subcortical" in depth:
        return "subcortical "
    if "deep" in depth:
        return "deep "
    if "cortical" in depth:
        return "cortical and subcortical "
    if "periventricular" in depth:
        return "periventricular "
    return ""


def _size_cm(tumor: Dict) -> float:
    cm = tumor.get("max_diameter_mm", 0) / 10.0
    return round(cm * 2) / 2


def _edema_ratio(tumor: Dict) -> float:
    total = tumor.get("volume_cm3", 1)
    if total <= 0:
        return 0.0
    return min(tumor.get("edema_volume_cm3", 0) / total, 1.0)


def _edema_degree(tumor: Dict) -> str:
    vol = tumor.get("edema_volume_cm3", 0)
    if vol < 5:
        return "Minimal"
    if vol < 15:
        return "Moderate"
    if vol < 30:
        return "Significant"
    return "Extensive"


def _necrosis_degree(necrosis: Dict) -> str:
    if not necrosis.get("present", False):
        return "none"
    ratio = necrosis.get("percentage", 0) / 100.0
    # clamp into the binned range: a 100% necrotic mass (ratio == 1.0)
    # would otherwise fall outside every half-open bin and read "minimal"
    ratio = min(max(ratio, 0.0), NECROSIS_THRESHOLDS["extensive"][1] - 1e-9)
    for degree, (lo, hi) in NECROSIS_THRESHOLDS.items():
        if lo <= ratio < hi:
            return degree
    return "minimal"


def extract_facts(summary: Dict) -> Dict:
    """All structured facts for the slot mapper (ref extract_facts :690-783)."""
    tumor = summary.get("tumor_characteristics", {})
    location = summary.get("location", {})
    multiplicity = summary.get("multiplicity", {})
    enhancement = summary.get("enhancement", {})
    necrosis = summary.get("necrosis", {})
    mass_effect = summary.get("mass_effect", {})
    morphology = summary.get("morphology", {})
    normal = summary.get("normal_structures", {})
    technique = summary.get("technique", {})
    patient = summary.get("patient_info", {})
    differential = summary.get("differential_considerations", [])

    vent = normal.get("ventricular_system", {})
    parenchyma = normal.get("parenchyma", {})
    shift = mass_effect.get("midline_shift_mm", 0)
    shift_significant = (
        isinstance(shift, (int, float)) and shift >= MIDLINE_SHIFT_THRESHOLD_MM
    )

    return {
        "case_id": summary.get("case_id", "Unknown"),
        "lesion_count": multiplicity.get("lesion_count", 1),
        "is_multifocal": multiplicity.get("lesion_count", 1) > 1,
        "distribution": _distribution(multiplicity),
        "hemisphere": location.get("hemisphere", "unknown"),
        "primary_lobe": location.get("primary_lobe", "unknown"),
        "involved_lobes": location.get("involved_lobes", []),
        "lobes_formatted": _lobes_formatted(location),
        "depth": location.get("depth", "").lower(),
        "depth_prefix": _depth_prefix(location),
        "max_diameter_mm": tumor.get("max_diameter_mm", 0),
        "size_cm": _size_cm(tumor),
        "volume_cm3": tumor.get("volume_cm3", 0),
        "enhancement_present": enhancement.get("present", False),
        "enhancement_pattern": enhancement.get("pattern", "").lower(),
        "enhancement_heterogeneity": (enhancement.get("heterogeneity") or "").lower(),
        "is_ring_enhancing": "ring" in (enhancement.get("pattern") or "").lower(),
        "necrosis_present": necrosis.get("present", False),
        "necrosis_percentage": necrosis.get("percentage", 0),
        "necrosis_degree": _necrosis_degree(necrosis),
        "necrosis_location": (necrosis.get("location") or "").lower(),
        "edema_volume_cm3": tumor.get("edema_volume_cm3", 0),
        "total_volume_cm3": tumor.get("volume_cm3", 0),
        "edema_ratio": _edema_ratio(tumor),
        "edema_degree": _edema_degree(tumor),
        "midline_shift_mm": shift,
        "shift_significant": shift_significant,
        "shift_direction": mass_effect.get("shift_direction", ""),
        "shape": (morphology.get("shape") or "mass").lower(),
        "ventricles_normal": "normal" in str(vent.get("size", "Normal")).lower(),
        "ventricles_symmetric": "asymmetric"
        not in str(vent.get("symmetry", "Symmetric")).lower(),
        "hydrocephalus": vent.get("hydrocephalus", False),
        "parenchyma_normal": "normal" in str(parenchyma.get("overall", "Normal")).lower(),
        "white_matter_disease": parenchyma.get("white_matter_disease", False),
        "sequences": technique.get("sequences_performed", []),
        "contrast_given": technique.get("contrast_administered", False),
        "clinical_history_provided": patient.get("clinical_history", "<not provided>")
        != "<not provided>",
        "clinical_history": patient.get("clinical_history", "<not provided>"),
        "prior_imaging_available": patient.get("relevant_prior_imaging", "<not provided>")
        != "<not provided>",
        "differentials": differential
        if differential
        else ["high-grade glioma", "metastasis", "lymphoma"],
    }
