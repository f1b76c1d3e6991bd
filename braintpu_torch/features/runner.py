"""Feature-extraction pipeline runner & LLM packaging.

Replaces upstream feature_extraction/run_all.py: runs steps 1-6 over
a single shared :class:`FeatureContext` (the reference reloads every NIfTI
per step), compiles the comprehensive text report (ref :37-125), and builds
``llm_ready_summary.json`` with the exact reference schema — patient-info
placeholders (ref :169-176), technique guard-notes (ref :178-192),
laterality cross-validation (ref :316-350), SNR-based reliability warnings
(ref :353-389).
"""

from __future__ import annotations

import datetime as _dt
from pathlib import Path
from typing import Dict, Optional

from .context import FeatureContext, save_json
from .step1_signals import analyze_sequence_findings
from .step2_mass_effect import analyze_mass_effect
from .step3_multiplicity import analyze_multiplicity
from .step4_morphology import analyze_morphology
from .step5_quality import analyze_quality
from .step6_normal_structures import analyze_normal_structures

__all__ = ["run_all_steps", "compile_comprehensive_report", "generate_llm_summary"]

_STEPS = [
    ("step1_sequence_findings", analyze_sequence_findings),
    ("step2_mass_effect", analyze_mass_effect),
    ("step3_multiplicity", analyze_multiplicity),
    ("step4_morphology", analyze_morphology),
    ("step5_quality", analyze_quality),
    ("step6_normal_structures", analyze_normal_structures),
]


def compile_comprehensive_report(all_results: Dict) -> str:
    """Full multi-section text report (ref run_all.py:37-125)."""
    step1 = all_results["step1_sequence_findings"]
    step2 = all_results["step2_mass_effect"]
    step3 = all_results["step3_multiplicity"]
    step5 = all_results["step5_quality"]

    volumes = step1.get("volumes", {})
    enhancement = step1.get("contrast_enhancement", {})
    location = step2.get("anatomical_location", {})

    bar, dash = "=" * 70, "-" * 70
    lines = [
        bar,
        "BRAIN MRI TUMOR ANALYSIS REPORT",
        bar,
        "",
        f"Case ID: {all_results['case_id']}",
        f"Analysis Date: {all_results['analysis_timestamp']}",
        "Model: BraTS 2021 KAIST MRI Lab (1st Place)",
        "",
        dash,
        "EXECUTIVE SUMMARY",
        dash,
        f"• Tumor Volume: {volumes.get('Whole Tumor (WT)', 0):.1f} cm³",
        f"• Location: {location.get('primary_lobe', 'Unknown').capitalize()} lobe, {location.get('laterality', 'Unknown')}",
        f"• Enhancement: {enhancement.get('pattern', 'Unknown')}",
        f"• Lesion Count: {step3.get('component_analysis', {}).get('num_components', 1)}",
        f"• Quality Score: {step5.get('segmentation_quality', {}).get('quality_score', 0)}/100",
        "",
    ]
    sections = [
        ("1. SEQUENCE-SPECIFIC FINDINGS", "step1_sequence_findings"),
        ("2. MASS EFFECT AND ANATOMICAL LOCATION", "step2_mass_effect"),
        ("3. LESION MULTIPLICITY AND DISTRIBUTION", "step3_multiplicity"),
        ("4. TUMOR MORPHOLOGY AND MARGINS", "step4_morphology"),
        ("5. QUALITY CONTROL", "step5_quality"),
        ("6. NORMAL STRUCTURES", "step6_normal_structures"),
    ]
    for title, key in sections:
        lines += [dash, title, dash, all_results.get(key, {}).get("text_summary", "Not available"), ""]
    lines += [bar, "END OF REPORT", bar]
    return "\n".join(lines)


def _validate_laterality(location: Dict, midline: Dict) -> Dict:
    loc_hemi = location.get("hemisphere", "Unknown")
    centroid_side = midline.get("tumor_hemisphere", "Unknown")
    loc_side = loc_hemi.split("-")[0] if "-" in loc_hemi else loc_hemi
    if loc_side == "bilateral" or "bilateral" in loc_hemi:
        return {
            "consistent": True,
            "note": "Bilateral tumor - crosses midline",
            "location_method": loc_hemi,
            "centroid_method": centroid_side,
        }
    if loc_side.lower() == str(centroid_side).lower():
        return {
            "consistent": True,
            "note": "Hemisphere determination consistent across methods",
            "location_method": loc_hemi,
            "centroid_method": centroid_side,
        }
    return {
        "consistent": False,
        "warning": (
            f"Hemisphere mismatch: location analysis suggests {loc_hemi}, centroid "
            f"analysis suggests {centroid_side}. Tumor may be near midline."
        ),
        "location_method": loc_hemi,
        "centroid_method": centroid_side,
    }


def _reliability_warnings(step5: Dict) -> list:
    warnings = []
    seq = step5.get("image_quality", {}).get("sequences", {})
    t2_snr = seq.get("T2", {}).get("snr_estimate", 10)
    if t2_snr < 6:
        warnings.append(
            {
                "sequence": "T2",
                "snr": t2_snr,
                "affected_measurements": [
                    "necrosis_fraction",
                    "cystic_solid_classification",
                    "edema_extent",
                ],
                "warning": (
                    f"Low T2 SNR ({t2_snr:.1f}) may reduce reliability of necrosis/cystic "
                    "fraction and edema measurements"
                ),
            }
        )
    t1ce_snr = seq.get("T1ce", {}).get("snr_estimate", 10)
    if t1ce_snr < 6:
        warnings.append(
            {
                "sequence": "T1ce",
                "snr": t1ce_snr,
                "affected_measurements": ["enhancement_analysis", "margin_sharpness"],
                "warning": (
                    f"Low T1ce SNR ({t1ce_snr:.1f}) may reduce reliability of enhancement "
                    "and margin measurements"
                ),
            }
        )
    overall = step5.get("image_quality", {}).get("overall_quality", "Good")
    if overall in ("Poor", "Fair"):
        warnings.append(
            {
                "overall": True,
                "warning": (
                    f"Overall image quality is {overall}; interpret quantitative "
                    "measurements with caution"
                ),
            }
        )
    return warnings


def generate_llm_summary(all_results: Dict) -> Dict:
    """Reference-schema llm_ready_summary (ref run_all.py:128-313)."""
    step1 = all_results["step1_sequence_findings"]
    step2 = all_results["step2_mass_effect"]
    step3 = all_results["step3_multiplicity"]
    step4 = all_results["step4_morphology"]
    step5 = all_results["step5_quality"]
    step6 = all_results.get("step6_normal_structures", {})

    volumes = step1.get("volumes", {})
    region_signals = step1.get("region_signal_analysis", {}).get("regions", {})
    enhancement = step1.get("contrast_enhancement", {})
    location = step2.get("anatomical_location", {})
    midline = step2.get("midline_shift", {})
    herniation = step2.get("herniation_risk", {})
    multiplicity = step3.get("component_analysis", {})
    distribution = step3.get("distribution_pattern", {})
    shape = step4.get("shape_descriptors", {})
    margins = step4.get("margin_definition", {})
    necrosis = step4.get("necrosis_pattern", {})
    cystic_solid = step4.get("cystic_solid_classification", {})
    quality = step5.get("segmentation_quality", {})
    artifacts = step5.get("artifact_detection", {})
    ventricular = step6.get("ventricular_system", {})
    parenchyma = step6.get("parenchyma", {})
    technique = step1.get("technique", {})
    acq = technique.get("acquisition_parameters", {})

    comps = multiplicity.get("components") or []
    max_diameter = comps[0].get("max_diameter_mm", 0) if comps else 0

    return {
        "case_id": all_results["case_id"],
        "analysis_date": all_results["analysis_timestamp"],
        "patient_info": {
            "age": "<not provided>",
            "sex": "<not provided>",
            "clinical_history": "<not provided>",
            "presenting_symptoms": "<not provided>",
            "relevant_prior_imaging": "<not provided>",
            "note": (
                "DO NOT fabricate patient demographics or clinical history. Only include "
                "information explicitly provided in clinical records."
            ),
        },
        "technique": {
            "sequences_performed": technique.get("sequences_performed", []),
            "sequences_not_available": technique.get(
                "sequences_not_available", ["DWI", "ADC", "MRS", "Perfusion"]
            ),
            "contrast_administered": technique.get("contrast_administered", False),
            "contrast_note": technique.get("contrast_note", "Unknown"),
            "acquisition_parameters": {
                "slice_thickness_mm": acq.get("slice_thickness_mm", "Not available"),
                "in_plane_resolution_mm": acq.get("in_plane_resolution_mm", "Not available"),
                "voxel_size_mm": acq.get("voxel_size_mm", "Not available"),
                "matrix_size": acq.get("matrix_size", "Not available"),
                "num_slices": acq.get("num_slices", "Not available"),
            },
            "note": (
                "LLM must only reference sequences listed in sequences_performed; do not "
                "infer or guess additional sequences"
            ),
        },
        "tumor_characteristics": {
            "volume_cm3": volumes.get("Whole Tumor (WT)", 0),
            "enhancing_volume_cm3": volumes.get("Enhancing Tumor (ET)", 0),
            "necrotic_volume_cm3": volumes.get("Necrotic Core (NCR)", 0),
            "edema_volume_cm3": volumes.get("Peritumoral Edema (ED)", 0),
            "max_diameter_mm": max_diameter,
        },
        "location": {
            "hemisphere": location.get("hemisphere", "Unknown"),
            "laterality": location.get("laterality", "Unknown"),
            "primary_lobe": location.get("primary_lobe", "Unknown"),
            "involved_lobes": location.get("lobes", []),
            "depth": location.get("depth", "Unknown"),
            "gyri": location.get("approximate_gyri", []),
            "laterality_validation": _validate_laterality(location, midline),
        },
        "signal_characteristics": {
            region: {
                "signal_summary": data.get("signal_summary", ""),
                "T1_ratio": data.get("T1", {}).get("ratio_to_normal", 0),
                "T2_ratio": data.get("T2", {}).get("ratio_to_normal", 0),
                "FLAIR_ratio": data.get("FLAIR", {}).get("ratio_to_normal", 0),
                "T1ce_ratio": data.get("T1ce", {}).get("ratio_to_normal", 0),
            }
            for region, data in region_signals.items()
        },
        "enhancement": {
            "present": enhancement.get("enhancement_present", False),
            "pattern": enhancement.get("pattern", "None"),
            "strength": enhancement.get("enhancement_strength", "None"),
            "heterogeneity": enhancement.get("heterogeneity", "N/A"),
        },
        "mass_effect": {
            "midline_shift_mm": midline.get("shift_mm", 0),
            "shift_significant": midline.get("is_significant", False),
            "shift_direction": midline.get("shift_direction", "None"),
            "herniation_risk": herniation.get("risk_level", "Low"),
            "mass_effect_score": herniation.get("mass_effect_score", 0),
        },
        "morphology": {
            "shape": shape.get("shape_classification", "Unknown"),
            "sphericity": shape.get("sphericity", 0),
            "elongation": shape.get("elongation", 1),
            "contour_shape": step4.get("border_regularity", {}).get("classification", "Unknown"),
            "contour_concept": "outer_surface_smoothness",
            "margin_transition": margins.get("classification", "Unknown"),
            "margin_concept": "intensity_transition_sharpness",
            "margin_sharpness": margins.get("margin_sharpness", 0),
            "combined_description": (
                f"{step4.get('border_regularity', {}).get('classification', 'Unknown')} contour "
                f"with {margins.get('classification', 'unknown').lower()} margins"
            ),
        },
        "necrosis": {
            "present": necrosis.get("necrosis_present", False),
            "pattern": necrosis.get("pattern", "None"),
            "percentage": necrosis.get("necrosis_percentage", 0),
            "location": necrosis.get("location", "N/A"),
        },
        "cystic_solid": {
            "classification": cystic_solid.get("classification", "Unknown"),
            "cystic_percentage": cystic_solid.get("cystic_percentage", 0),
            "solid_percentage": cystic_solid.get("solid_percentage", 100),
            "description": cystic_solid.get("description", ""),
        },
        "multiplicity": {
            "lesion_count": multiplicity.get("num_components", 1),
            "is_single_lesion": multiplicity.get("is_single_lesion", True),
            "distribution_pattern": distribution.get("pattern", "Solitary"),
            "has_satellites": step3.get("satellite_analysis", {}).get("has_satellites", False),
        },
        "differential_considerations": distribution.get("differential_considerations", []),
        "normal_structures": {
            "ventricular_system": {
                "size": ventricular.get("size_assessment", "Not assessed"),
                "volume_cm3": ventricular.get("total_volume_cm3", 0),
                "hydrocephalus": ventricular.get("hydrocephalus_present", False),
                "symmetry": ventricular.get("symmetry_assessment", "Unknown"),
            },
            "parenchyma": {
                "gray_white_differentiation": parenchyma.get("gray_white_differentiation", {}).get(
                    "assessment", "Unknown"
                ),
                "white_matter_disease": parenchyma.get("periventricular_assessment", {}).get(
                    "white_matter_disease_present", False
                ),
                "overall": parenchyma.get("overall_assessment", "Unknown"),
            },
        },
        "quality_metrics": {
            "segmentation_score": quality.get("quality_score", 0),
            "segmentation_grade": quality.get("grade", "Unknown"),
            "image_quality": step5.get("image_quality", {}).get("overall_quality", "Unknown"),
            "sequence_quality": {
                seq: data.get("quality", "Unknown")
                for seq, data in step5.get("image_quality", {}).get("sequences", {}).items()
            },
            "artifacts": {
                "detected": artifacts.get("artifacts_detected", []),
                "severity": artifacts.get("severity", "None"),
                "impact": artifacts.get("impact_on_analysis", "Unknown"),
            },
            "confidence_high": ["volume_measurements", "multiplicity", "enhancement_analysis"],
            "confidence_moderate": ["midline_shift", "margin_analysis", "anatomical_localization"],
        },
        "measurement_reliability_warnings": _reliability_warnings(step5),
        "caveats": step5.get("limitations_and_caveats", {}).get("caveats", []),
    }


def run_all_steps(
    input_folder,
    segmentation_path,
    output_folder,
    ctx: Optional[FeatureContext] = None,
    progress=None,
) -> Dict:
    """Run steps 1-6 and write the reference's output file set.

    ``progress`` is an optional callable ``(step_name) -> None`` used by the
    orchestrator for structured progress events.
    """
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    if ctx is None:
        ctx = FeatureContext.load(input_folder, segmentation_path)

    all_results: Dict = {
        "case_id": ctx.case_id,
        "analysis_timestamp": _dt.datetime.now().isoformat(),
        "input_folder": str(input_folder),
        "segmentation_path": str(segmentation_path),
    }
    for name, fn in _STEPS:
        if progress:
            progress(name)
        result = fn(ctx)
        all_results[name] = result
        save_json(result, output_folder / f"{name}.json")

    report = compile_comprehensive_report(all_results)
    all_results["comprehensive_report"] = report
    llm_summary = generate_llm_summary(all_results)
    all_results["llm_summary"] = llm_summary

    save_json(all_results, output_folder / "comprehensive_analysis.json")
    save_json(llm_summary, output_folder / "llm_ready_summary.json")
    (output_folder / "radiology_report.txt").write_text(report, encoding="utf-8")
    return all_results
