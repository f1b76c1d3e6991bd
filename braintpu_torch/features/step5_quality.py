"""Feature step 5: quality control & confidence metrics.

Semantics-parity re-implementation of
upstream feature_extraction/step5_quality.py:
* segmentation QC score 0-100 with the 8 deductive checks (no-tumor -50,
  size bounds ±10, TC⊆WT -20, >5 fragments -5, ET⊆TC -5, >10 % holes -5,
  boundary truncation -10; ref :32-159),
* per-sequence SNR estimate + zero/outlier fractions + quality grades with
  SNR bins 5/10/20 (ref :162-258),
* artifact detectors: bias-field center/periphery ratio (0.7/1.4 bounds),
  ghosting background CV > 0.5, susceptibility inferior-zeros, wrap-around
  edge signal (≥3 edges), Gibbs edge-gradient CV > 1.5 (ref :261-454),
* fixed measurement-confidence table (ref :457-500),
* limitations & caveats incl. guarded non-enhancing language (ref :503-545).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy import ndimage
from scipy.ndimage import sobel

from .boxops import binary_erosion_bbox

from .context import FeatureContext

__all__ = ["analyze_quality"]

SEQ_DISPLAY = {"t1": "T1", "t1ce": "T1ce", "t2": "T2", "flair": "FLAIR"}


def assess_segmentation_quality(ctx: FeatureContext) -> Dict:
    """Segmentation QC score 0-100 (ref step5_quality.py:32-159, same
    deduction rubric).

    Known-vacuous checks (deliberate reference parity, not bugs here):
    the TC>WT and ET-outside-TC deductions can never fire because the
    masks are DERIVED from one label map (tc = ncr|et ⊆ wt = seg>0 and
    et ⊆ tc by construction — the reference's utils.get_tumor_masks has
    the identical containment).  The reference authors wrote those checks
    for multi-channel/probabilistic segmentations; on label maps they are
    kept only so the score rubric and JSON schema match.
    """
    masks = ctx.tumor_masks
    issues: List[str] = []
    warnings: List[str] = []
    score = 100
    v = ctx.voxel_volume_cm3
    wt_vol = float(ctx.region_count("wt") * v)
    tc_vol = float(ctx.region_count("tc") * v)
    et = masks["et"]

    if wt_vol == 0:
        issues.append("No tumor segmentation detected")
        return {
            "quality_score": 50,
            "grade": "Poor",
            "issues": issues,
            "warnings": warnings,
            "recommendation": "Manual review required - no segmentation found",
        }
    if wt_vol < 0.5:
        warnings.append(f"Very small tumor volume ({wt_vol:.2f} cm³) - may be artifact")
        score -= 10
    if wt_vol > 300:
        warnings.append(f"Very large tumor volume ({wt_vol:.0f} cm³) - verify boundaries")
        score -= 10
    if tc_vol > wt_vol * 1.01:
        issues.append("Tumor core volume exceeds whole tumor - label inconsistency")
        score -= 20

    # every wt component lives inside the wt bounding box, and holes are
    # by definition enclosed by wt — both checks are exact on the box and
    # ~8x cheaper than the full 240³ grid
    from .boxops import bbox_slices

    wt_sl = bbox_slices(masks["wt"], pad=1)
    wt_box = masks["wt"][wt_sl]

    structure = ndimage.generate_binary_structure(3, 3)
    _, num_components = ndimage.label(wt_box, structure=structure)
    if num_components > 5:
        warnings.append(
            f"Multiple disconnected components ({num_components}) - possible over-segmentation"
        )
        score -= 5

    et_count = ctx.region_count("et")
    if et_count > 0:
        outside = et[wt_sl] & ~masks["tc"][wt_sl]  # et ⊆ wt: box is exact
        if outside.sum() > et_count * 0.05:
            warnings.append("Some enhancing tumor voxels outside tumor core boundary")
            score -= 5

    filled = ndimage.binary_fill_holes(wt_box)
    holes = filled & ~wt_box
    wt_count = ctx.region_count("wt")
    hole_fraction = float(holes.sum() / wt_count) if wt_count > 0 else 0.0
    if hole_fraction > 0.1:
        warnings.append(f"Segmentation has internal holes ({hole_fraction*100:.0f}% of volume)")
        score -= 5

    m = 3
    wt = masks["wt"]
    at_boundary = bool(
        wt[:m].any()
        or wt[-m:].any()
        or wt[:, :m].any()
        or wt[:, -m:].any()
        or wt[:, :, :m].any()
        or wt[:, :, -m:].any()
    )
    if at_boundary:
        warnings.append("Tumor extends to image boundary - may be truncated")
        score -= 10

    if score >= 90:
        grade, rec = "Excellent", "High confidence in segmentation quality"
    elif score >= 75:
        grade, rec = "Good", "Acceptable quality, routine review recommended"
    elif score >= 60:
        grade, rec = "Fair", "Some concerns identified, careful review advised"
    elif score >= 40:
        grade, rec = "Poor", "Multiple issues detected, manual verification required"
    else:
        grade, rec = "Unacceptable", "Significant problems, re-segmentation may be needed"

    return {
        "quality_score": max(0, score),
        "grade": grade,
        "issues": issues,
        "warnings": warnings,
        "num_components": int(num_components),
        "hole_fraction": hole_fraction,
        "at_image_boundary": at_boundary,
        "recommendation": rec,
    }


def assess_image_quality(ctx: FeatureContext) -> Dict:
    brain = ctx.brain_mask("t1")
    metrics: Dict[str, Dict] = {}
    overall_issues: List[str] = []
    for mod, name in SEQ_DISPLAY.items():
        data = ctx.modalities[mod]
        seq_issues: List[str] = []
        brain_values = data[brain]
        if brain_values.size == 0:
            seq_issues.append("No brain tissue detected")
            metrics[name] = {"snr_estimate": 0, "issues": seq_issues, "quality": "Poor"}
            continue
        signal_mean = float(brain_values.mean())
        brain_std = float(brain_values.std())
        # background noise = positive out-of-brain voxels below the
        # 10th percentile of ALL positive voxels.  Computed on the
        # gathered 1-D subsets (out_vals[out_vals < p10]) — identical
        # value multiset to the previous 3-D mask
        # ``~brain & (data > 0) & (data < p10)``, four fewer
        # full-volume passes per modality.
        out_vals = ctx.background_values(mod)
        # noise floor = 10th percentile of ALL positive voxels (shared
        # per-case gather); a blank/corrupt modality can have a
        # non-empty brain mask (it is shared across modalities) but
        # zero positive voxels — np.percentile on the empty array
        # would abort the whole run
        nz = ctx.positive_values(mod)
        if nz.size:
            bg_values = out_vals[out_vals < np.percentile(nz, 10)]
        else:
            bg_values = out_vals
        if bg_values.size > 100:
            bg_std = float(bg_values.std())
            snr = signal_mean / bg_std if bg_std > 0 else 0.0
        else:
            snr = signal_mean / brain_std if brain_std > 0 else 0.0

        # zeros-in-brain from the already-gathered brain values
        zero_fraction = float((brain_values == 0).sum() / brain_values.size)

        q01, q25, q75, q99 = np.percentile(brain_values, [1, 25, 75, 99])
        iqr = q75 - q25
        outliers = int((brain_values > q99 + 3 * iqr).sum() + (brain_values < q01 - 3 * iqr).sum())
        outlier_fraction = outliers / brain_values.size

        if zero_fraction > 0.01:
            seq_issues.append(f"Missing data: {zero_fraction*100:.1f}% zeros within brain")
        if outlier_fraction > 0.01:
            seq_issues.append(f"Intensity outliers detected ({outlier_fraction*100:.1f}%)")

        if snr > 20 and not seq_issues:
            quality = "Excellent"
        elif snr > 10 and len(seq_issues) <= 1:
            quality = "Good"
        elif snr > 5:
            quality = "Fair"
        else:
            quality = "Poor"

        metrics[name] = {
            "snr_estimate": float(snr),
            "zero_fraction": float(zero_fraction),
            "outlier_fraction": float(outlier_fraction),
            "mean_intensity": float(signal_mean),
            "std_intensity": float(brain_std),
            "issues": seq_issues,
            "quality": quality,
        }
        overall_issues.extend(f"{name}: {i}" for i in seq_issues)

    qualities = [m["quality"] for m in metrics.values()]
    if all(q == "Excellent" for q in qualities):
        overall = "Excellent"
    elif all(q in ("Excellent", "Good") for q in qualities):
        overall = "Good"
    elif any(q == "Poor" for q in qualities):
        overall = "Poor"
    else:
        overall = "Fair"
    return {"sequences": metrics, "overall_quality": overall, "issues": overall_issues}


def detect_artifacts(ctx: FeatureContext) -> Dict:
    brain = ctx.brain_mask("t1")
    t1 = ctx.modalities["t1"]
    detected: List[str] = []
    details: Dict[str, Dict] = {}
    if brain.any():
        # center-vs-periphery rings via a bbox-broadcast SQUARED distance
        # field: identical ring membership (sqrt is monotone, so
        # dist < 0.3·max ⟺ dist² < 0.09·max²) without materializing three
        # ~5M-entry coordinate arrays (np.nonzero was the hottest line of
        # step 5 in the round-3 cProfile)
        from .boxops import bbox_slices

        sl = bbox_slices(brain)
        bb = brain[sl]
        total = float(bb.sum())
        axes_idx = [
            np.arange(s.start, s.stop, dtype=np.float64) for s in sl
        ]
        counts = [
            bb.sum(axis=tuple(a for a in range(3) if a != i)).astype(np.float64)
            for i in range(3)
        ]
        center = [float((axes_idx[i] * counts[i]).sum() / total) for i in range(3)]
        d2 = (
            ((axes_idx[0] - center[0]) ** 2)[:, None, None]
            + ((axes_idx[1] - center[1]) ** 2)[None, :, None]
            + ((axes_idx[2] - center[2]) ** 2)[None, None, :]
        )
        dd = d2[bb]
        max_d2 = dd.max()
        brain_vals = t1[sl][bb]
        inner = brain_vals[dd < max_d2 * 0.09]
        outer = brain_vals[dd > max_d2 * 0.49]
        inner_n, outer_n = inner.size, outer.size
        inner_mean = float(inner.mean()) if inner_n else 0.0
        outer_mean = float(outer.mean()) if outer_n else 0.0
    else:
        inner_n = outer_n = 0
        inner_mean = outer_mean = 0.0
    if inner_n > 100 and outer_n > 100:
        ratio = float(outer_mean / inner_mean) if inner_mean > 0 else 1.0
        if ratio < 0.7 or ratio > 1.4:
            detected.append("Intensity inhomogeneity")
            details["intensity_inhomogeneity"] = {
                "detected": True,
                "severity": "Moderate" if 0.6 < ratio < 1.6 else "Severe",
                "ratio": ratio,
                "description": "Significant signal intensity variation across the brain (bias field artifact)",
                "impact": "May affect intensity-based measurements",
            }
        else:
            details["intensity_inhomogeneity"] = {"detected": False, "ratio": ratio}

    for mod, name in SEQ_DISPLAY.items():
        vals = ctx.background_values(mod)
        bg_n = int(vals.size)
        bg_mean = float(vals.mean()) if bg_n else 0.0
        bg_std = float(vals.std()) if bg_n else 0.0
        if bg_n > 1000:
            cv = float(bg_std / bg_mean) if bg_mean > 0 else 0.0
            if cv > 0.5:
                if "motion_ghosting" not in details:
                    detected.append("Possible motion artifact")
                    details["motion_ghosting"] = {
                        "detected": True,
                        "affected_sequences": [name],
                        "background_cv": cv,
                        "description": "Elevated background signal variation suggests possible motion/ghosting",
                        "impact": "May affect tumor boundary delineation",
                    }
                else:
                    details["motion_ghosting"]["affected_sequences"].append(name)
    details.setdefault("motion_ghosting", {"detected": False})

    zero_clusters = (t1 == 0) & brain
    zero_count = int(zero_clusters.sum())

    def _mean_z(mask):
        # mean z-coordinate via the z-projection histogram — equal to
        # np.nonzero(mask)[2].mean() without materializing coordinates
        cz = mask.sum(axis=(0, 1)).astype(np.float64)
        n = cz.sum()
        return float((np.arange(cz.size) * cz).sum() / n) if n else 0.0

    mean_z = _mean_z(zero_clusters) if zero_count else 0.0
    brain_z = _mean_z(brain)
    if zero_count > 100:
        if mean_z < brain_z * 0.5:
            detected.append("Susceptibility artifact")
            details["susceptibility"] = {
                "detected": True,
                "location": "Inferior brain (near skull base)",
                "volume_mm3": float(zero_count),
                "description": "Signal dropout in inferior brain, typical susceptibility artifact near air-bone interface",
                "impact": "May affect assessment of inferior tumor components",
            }
        else:
            details["susceptibility"] = {
                "detected": True,
                "location": "Atypical location",
                "description": "Signal voids detected in unexpected location - may indicate pathology or artifact",
            }
    else:
        details["susceptibility"] = {"detected": False}

    m = 5
    edge_signal = {
        "x_min": bool(t1[:m].max() > 0),
        "x_max": bool(t1[-m:].max() > 0),
        "y_min": bool(t1[:, :m].max() > 0),
        "y_max": bool(t1[:, -m:].max() > 0),
    }
    if sum(edge_signal.values()) >= 3:
        detected.append("Possible wrap-around")
        details["wrap_around"] = {
            "detected": True,
            "description": "Brain tissue extends to image boundaries - possible aliasing or tight FOV",
            "edges_affected": [k for k, v in edge_signal.items() if v],
            "impact": "Anatomy at edges may be compromised",
        }
    else:
        details["wrap_around"] = {"detected": False}

    if ctx.seg.max() > 0:
        tumor = ctx.tumor_masks["wt"]
        edge = tumor & ~binary_erosion_bbox(tumor, iterations=2)
        edge_count = int(edge.sum())
        if edge_count:
            # gradients are read ONLY at tumor-edge voxels; sobel's
            # 3-tap stencil makes a box padded by 2 exact there —
            # three full-volume f64 sobel passes reduced to the box
            from .boxops import bbox_slices

            sl = bbox_slices(edge, pad=2)
            tb = t1[sl].astype(float)
            g = np.sqrt(
                sobel(tb, axis=0) ** 2
                + sobel(tb, axis=1) ** 2
                + sobel(tb, axis=2) ** 2
            )
            vals = g[edge[sl]]
            g_mean, g_std = float(vals.mean()), float(vals.std())
        else:
            g_mean = g_std = 0.0
        if edge_count > 100:
            cv = float(g_std / g_mean) if g_mean > 0 else 0.0
            if cv > 1.5:
                detected.append("Possible Gibbs ringing")
                details["gibbs_ringing"] = {
                    "detected": True,
                    "edge_gradient_cv": cv,
                    "description": "High gradient variation at tumor margins, may indicate Gibbs/truncation artifact",
                    "impact": "May affect precise tumor boundary measurement",
                }
            else:
                details["gibbs_ringing"] = {"detected": False}
        else:
            details["gibbs_ringing"] = {"detected": False, "note": "Insufficient edge for analysis"}
    else:
        details["gibbs_ringing"] = {"detected": False}

    if not detected:
        overall, severity = "No significant artifacts detected", "None"
    elif len(detected) <= 2:
        overall, severity = f"Minor artifacts detected: {', '.join(detected)}", "Mild"
    else:
        overall, severity = f"Multiple artifacts present: {', '.join(detected)}", "Moderate to Severe"

    return {
        "artifacts_detected": detected,
        "artifact_count": len(detected),
        "severity": severity,
        "overall_assessment": overall,
        "details": details,
        "impact_on_analysis": "Review recommended" if len(detected) > 1 else "Minimal impact expected",
    }


def calculate_measurement_confidence() -> Dict:
    """Fixed confidence table (ref :457-500)."""
    return {
        "volume_measurements": {
            "confidence": "High",
            "note": "Volume calculations are mathematically precise given the segmentation",
        },
        "enhancement_analysis": {
            "confidence": "High",
            "note": "Based on objective intensity comparisons",
        },
        "midline_shift": {
            "confidence": "Moderate",
            "note": "Estimated from tissue asymmetry; clinical correlation recommended",
        },
        "margin_analysis": {
            "confidence": "Moderate",
            "note": "Based on intensity gradients; subjective component remains",
        },
        "anatomical_localization": {
            "confidence": "Moderate",
            "note": "Based on standard atlas coordinates; individual variation exists",
        },
        "multiplicity": {
            "confidence": "High",
            "note": "3D connected component analysis is objective",
        },
    }


def identify_limitations(ctx: FeatureContext, seg_quality: Dict, image_quality: Dict) -> Dict:
    limitations = [
        "Automated analysis should be verified by qualified radiologist",
        "Segmentation based on BraTS 2021 model trained on glioma cases",
        "DWI/ADC sequences not available - diffusion characteristics not assessed",
        "Perfusion imaging not available - cannot assess tumor vascularity",
    ]
    caveats: List[str] = []
    if ctx.tumor_masks["et"].sum() == 0:
        caveats.append(
            "Non-enhancing pattern: Can be seen with lower-grade glioma, treatment effect, "
            "or other pathology; clinical and histopathological correlation required"
        )
    if seg_quality.get("at_image_boundary", False):
        caveats.append("Tumor at image boundary: Volume may be underestimated")
    t2_snr = image_quality.get("sequences", {}).get("T2", {}).get("snr_estimate", 10)
    if t2_snr < 6:
        caveats.append(
            f"Low T2 SNR ({t2_snr:.1f}): Necrosis fraction and cystic/solid classification less reliable"
        )
    if image_quality.get("overall_quality") in ("Fair", "Poor"):
        caveats.append("Suboptimal image quality may affect measurement accuracy")
    caveats.append("Model optimized for adult gliomas; performance may vary for other tumor types")
    caveats.append(
        "Peritumoral edema vs infiltrating tumor cannot be distinguished on conventional MRI"
    )
    return {"limitations": limitations, "caveats": caveats}


def _text_summary(results: Dict) -> str:
    lines = ["QUALITY CONTROL AND CONFIDENCE ASSESSMENT:", ""]
    seg = results["segmentation_quality"]
    lines.append(f"Segmentation Quality: {seg['grade']} (Score: {seg['quality_score']}/100)")
    lines.append(f"  {seg['recommendation']}")
    if seg["issues"]:
        lines.append("  Issues:")
        lines += [f"    ⚠ {i}" for i in seg["issues"]]
    if seg["warnings"]:
        lines.append("  Warnings:")
        lines += [f"    ⚡ {w}" for w in seg["warnings"]]
    lines.append("")
    img = results["image_quality"]
    lines.append(f"Image Quality: {img['overall_quality']}")
    for seq, m in img["sequences"].items():
        lines.append(f"  - {seq}: {m['quality']} (SNR ≈ {m['snr_estimate']:.1f})")
    lines.append("")
    art = results.get("artifact_detection", {})
    if art:
        lines.append(f"Artifact Assessment: {art.get('severity', 'Not assessed')}")
        lines.append(f"  {art.get('overall_assessment', 'Not assessed')}")
        for a in art.get("artifacts_detected", []):
            lines.append(f"    • {a}")
    lines += ["", "Measurement Confidence:"]
    for measure, conf in results["measurement_confidence"].items():
        lines.append(f"  - {measure.replace('_', ' ').title()}: {conf['confidence']}")
    lines += ["", "Key Limitations:"]
    for lim in results["limitations_and_caveats"]["limitations"][:3]:
        lines.append(f"  • {lim}")
    if results["limitations_and_caveats"]["caveats"]:
        lines += ["", "Case-Specific Caveats:"]
        for cav in results["limitations_and_caveats"]["caveats"]:
            lines.append(f"  • {cav}")
    return "\n".join(lines)


def analyze_quality(ctx: FeatureContext) -> Dict:
    """Run step 5 on a loaded case; returns the reference-schema dict."""
    seg_quality = assess_segmentation_quality(ctx)
    image_quality = assess_image_quality(ctx)
    artifact_detection = detect_artifacts(ctx)
    confidence = calculate_measurement_confidence()
    limitations = identify_limitations(ctx, seg_quality, image_quality)
    results = {
        "case_id": ctx.case_id,
        "step": "Step 5 - Quality control and confidence metrics",
        "segmentation_quality": seg_quality,
        "image_quality": image_quality,
        "artifact_detection": artifact_detection,
        "measurement_confidence": confidence,
        "limitations_and_caveats": limitations,
    }
    results["text_summary"] = _text_summary(results)
    return results
