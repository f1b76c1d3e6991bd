"""Feature step 2: mass-effect metrics and atlas-free localization.

Semantics-parity re-implementation of
upstream feature_extraction/step2_mass_effect.py:
* midline shift from hemispheric center-of-mass asymmetry, 1 mm noise floor,
  severity bins 3/5/10 mm (ref :29, :32-156),
* ventricular compression via CSF-percentile (15th) asymmetry with 0.7×
  side-dominance rule and 0.15/0.3/0.5 severity bins (ref :159-253),
* sulcal effacement via peritumoral-vs-distant intensity-variance ratio with
  0.6/0.8 bins (ref :358-414),
* herniation risk as a 0-7 composite of the above (ref :256-355),
* anatomical localization: hemisphere by voxel split (90 %/60 % cutoffs),
  four lobes + deep structures by fractional bounding boxes, depth by
  relative distance from volume center, pseudo-gyri by lobe+height
  (ref :417-602).

Deliberate deviation (documented per SURVEY.md §7 "hard parts"): the
reference estimates the tumor→ventricle distance by random point sampling
(``np.random.choice`` at ref :215) — non-deterministic run to run.  Here it
is the exact minimum computed from a Euclidean distance transform of the CSF
mask, which is deterministic and a strict accuracy improvement of the same
quantity.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .context import FeatureContext

__all__ = ["analyze_mass_effect", "SHIFT_NOISE_THRESHOLD_MM"]

SHIFT_NOISE_THRESHOLD_MM = 1.0


def _centroid(mask: np.ndarray) -> Optional[Dict[str, float]]:
    if mask.sum() == 0:
        return None
    c = np.array(np.nonzero(mask)).mean(axis=1)
    return {"x": float(c[0]), "y": float(c[1]), "z": float(c[2])}


def _bounding_box(mask: np.ndarray) -> Optional[Dict[str, int]]:
    if mask.sum() == 0:
        return None
    coords = np.nonzero(mask)
    out = {}
    for axis, name in enumerate("xyz"):
        lo, hi = int(coords[axis].min()), int(coords[axis].max())
        out[f"min_{name}"] = lo
        out[f"max_{name}"] = hi
        out[f"size_{name}"] = hi - lo + 1
    return out


def _shift_direction(estimated_shift: float, tumor_side: str) -> str:
    if estimated_shift > 0:
        return "Left to right" if tumor_side == "left" else "Right to left"
    return "Right to left" if tumor_side == "left" else "Left to right"


def calculate_midline_shift(ctx: FeatureContext) -> Dict:
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]
    vx = ctx.zooms[0]

    if tumor.sum() == 0:
        return {
            "shift_mm": 0,
            "shift_direction": "Not applicable",
            "severity": "No tumor detected",
            "clinical_significance": "No tumor present to cause mass effect",
            "is_significant": False,
        }
    per_x = brain.sum(axis=(1, 2)).astype(np.float64)  # voxels per slab
    tumor_cx_f = float(np.nonzero(tumor)[0].mean())
    xs = np.nonzero(per_x > 0)[0]
    if xs.size == 0:
        return {
            "shift_mm": None,
            "shift_direction": "Unknown",
            "severity": "Could not calculate",
            "clinical_significance": "Brain mask could not be determined",
            "is_significant": False,
        }
    x_min, x_max = int(xs[0]), int(xs[-1])
    midline_x = (x_min + x_max) / 2
    brain_width = x_max - x_min

    tumor_cx = tumor_cx_f
    tumor_side = "left" if tumor_cx < midline_x else "right"
    distance_to_midline = abs(tumor_cx - midline_x) * vx

    mid = int(midline_x)
    x_idx = np.arange(brain.shape[0])
    left_n, right_n = per_x[:mid].sum(), per_x[mid:].sum()
    if left_n > 0 and right_n > 0:
        left_com = (x_idx[:mid] * per_x[:mid]).sum() / left_n
        right_com = (x_idx[mid:] * per_x[mid:]).sum() / right_n
        expected_left = midline_x - brain_width / 4
        expected_right = midline_x + brain_width / 4
        estimated = ((left_com - expected_left) + (right_com - expected_right)) / 2 * vx
    else:
        estimated = 0.0
    shift_mm = abs(float(estimated))
    significant = shift_mm >= SHIFT_NOISE_THRESHOLD_MM

    if not significant:
        direction, severity = "Not applicable (below measurement threshold)", "None"
        clinical = "No significant midline shift detected"
    else:
        direction = _shift_direction(estimated, tumor_side)
        if shift_mm < 3:
            severity, clinical = "Minimal", "No significant midline shift detected"
        elif shift_mm < 5:
            severity, clinical = "Mild", "Mild midline shift, close monitoring recommended"
        elif shift_mm < 10:
            severity, clinical = "Moderate", "Moderate midline shift, close monitoring recommended"
        else:
            severity, clinical = "Severe", "Severe midline shift, may require urgent intervention"

    return {
        "shift_mm": shift_mm,
        "shift_direction": direction,
        "tumor_hemisphere": tumor_side,
        "severity": severity,
        "clinical_significance": clinical,
        "is_significant": significant,
        "brain_midline_x": float(midline_x),
        "tumor_centroid_x": tumor_cx,
        "distance_to_midline_mm": float(distance_to_midline),
        "measurement_threshold_mm": SHIFT_NOISE_THRESHOLD_MM,
        "note": "Estimated from tissue asymmetry - clinical correlation recommended",
    }


def analyze_ventricular_compression(ctx: FeatureContext) -> Dict:
    t1 = ctx.modalities["t1"]
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]
    if not brain.any():
        return {
            "compression_detected": False,
            "severity": "Could not analyze",
            "asymmetry_ratio": 0,
            "details": "Could not analyze - no brain tissue detected",
        }
    vox_cm3 = ctx.voxel_volume_mm3 / 1000.0
    csf_threshold = np.percentile(t1[brain], 15)
    csf = (t1 < csf_threshold) & (t1 > 0) & ~tumor
    mid = t1.shape[0] // 2
    left_vol = float(csf[:mid].sum() * vox_cm3)
    right_vol = float(csf[mid:].sum() * vox_cm3)
    total = left_vol + right_vol
    asym = abs(left_vol - right_vol) / total if total > 0 else 0.0

    if left_vol < right_vol * 0.7:
        side, detected = "left", True
    elif right_vol < left_vol * 0.7:
        side, detected = "right", True
    else:
        side, detected = "none", False

    min_dist = None
    if tumor.any() and (left_vol + right_vol) > 0:
        # Exact: EDT of the CSF complement sampled at tumor voxels (in mm),
        # computed on an escalating tumor-padded box.  Every point outside
        # a box padded by P voxels is > P·min(zoom) mm from every tumor
        # voxel, so a computed minimum below that bound cannot be beaten
        # by out-of-box CSF — i.e. it IS the full-volume answer.  Typical
        # tumors sit within ~32 voxels of ventricular CSF, making the
        # first box ~25x smaller than the 240^3 grid.
        from .boxops import bbox_slices, edt

        min_zoom = float(min(ctx.zooms))
        for pad in (32, 64, 128, max(t1.shape)):
            sl = bbox_slices(tumor, pad=pad)
            csf_sl = csf[sl]
            if not csf_sl.any():
                continue  # nearest CSF lies beyond this box — escalate
            dist = edt(~csf_sl, sampling=ctx.zooms)
            md = float(dist[tumor[sl]].min())
            full_box = all(
                s.start == 0 and s.stop == n
                for s, n in zip(sl, t1.shape)
            )
            if md < pad * min_zoom or full_box:
                min_dist = md
                break

    if asym > 0.5:
        severity = "Severe"
    elif asym > 0.3:
        severity = "Moderate"
    elif asym > 0.15:
        severity = "Mild"
    else:
        severity = "None/Minimal"

    return {
        "compression_detected": detected,
        "compressed_side": side,
        "asymmetry_ratio": float(asym),
        "left_ventricle_volume_cm3": left_vol,
        "right_ventricle_volume_cm3": right_vol,
        "severity": severity,
        "tumor_to_ventricle_distance_mm": min_dist,
        "note": "Based on CSF intensity analysis - MRI sequence-dependent",
    }


def analyze_sulcal_effacement(ctx: FeatureContext) -> Dict:
    t1 = ctx.modalities["t1"]
    tumor = ctx.tumor_masks["wt"]
    brain = ctx.brain_mask("t1")
    if tumor.sum() == 0:
        return {
            "effacement_detected": False,
            "severity": "No tumor detected",
            "details": "No tumor detected",
        }
    expanded = ctx.dilated_wt(10)
    peritumoral = expanded & ~tumor & brain
    distant = brain & ~expanded
    peri_count = int(peritumoral.sum())
    distant_count = int(distant.sum())
    peri_std = float(t1[peritumoral].std()) if peri_count else 0.0
    distant_std = float(t1[distant].std()) if distant_count else 0.0
    if peri_count == 0:
        return {
            "effacement_detected": False,
            "severity": "Could not analyze",
            "details": "Could not analyze peritumoral region",
        }
    if distant_count == 0:
        return {
            "effacement_detected": True,
            "severity": "Severe",
            "details": "Tumor occupies majority of brain volume",
        }
    ratio = peri_std / distant_std if distant_std > 0 else 1.0
    if ratio < 0.6:
        detected, severity = True, "Moderate to Severe"
    elif ratio < 0.8:
        detected, severity = True, "Mild to Moderate"
    else:
        detected, severity = False, "None/Minimal"
    return {
        "effacement_detected": detected,
        "severity": severity,
        "variance_ratio": float(ratio),
        "peritumoral_intensity_std": peri_std,
        "normal_brain_intensity_std": distant_std,
        "note": "Based on intensity variance analysis",
    }


def assess_herniation_risk(
    midline: Dict, ventricular: Dict, sulcal: Dict, tumor_volume_cm3: float
) -> Dict:
    risk_factors: List[str] = []
    signs: List[str] = []
    shift = midline.get("shift_mm", 0) or 0
    asym = ventricular.get("asymmetry_ratio", 0) or 0
    sulcal_sev = sulcal.get("severity", "None/Minimal")

    score = 0.0
    if shift >= 10:
        score += 4
        risk_factors.append(f"Midline shift: {shift:.1f}mm (severe)")
        signs.append("Severe midline shift (>10mm) - high subfalcine herniation risk")
    elif shift >= 5:
        score += 3
        risk_factors.append(f"Midline shift: {shift:.1f}mm (moderate)")
        signs.append("Moderate midline shift (5-10mm) - subfalcine herniation possible")
    elif shift >= 3:
        score += 2
        risk_factors.append(f"Midline shift: {shift:.1f}mm (mild)")
        signs.append("Mild midline shift (3-5mm) - early mass effect")
    elif shift >= 1:
        score += 1
        risk_factors.append(f"Midline shift: {shift:.1f}mm (minimal)")

    if asym > 0.5:
        score += 2
        risk_factors.append(f"Ventricular asymmetry: {asym:.2f} (severe)")
        signs.append("Severe ventricular asymmetry - significant mass effect")
    elif asym > 0.3:
        score += 1
        risk_factors.append(f"Ventricular asymmetry: {asym:.2f} (moderate)")
    elif asym > 0.15:
        score += 0.5
        risk_factors.append(f"Ventricular asymmetry: {asym:.2f} (mild)")

    if sulcal_sev in ("Moderate to Severe", "Severe"):
        score += 1
        risk_factors.append(f"Sulcal effacement: {sulcal_sev}")
    elif sulcal_sev == "Mild to Moderate":
        score += 0.5
        risk_factors.append(f"Sulcal effacement: {sulcal_sev}")

    if score >= 5:
        level = "High"
    elif score >= 3:
        level = "Moderate"
    elif score >= 1.5:
        level = "Mild"
    else:
        level = "Low"

    if not signs:
        if tumor_volume_cm3 > 50:
            signs.append(
                f"Large tumor ({tumor_volume_cm3:.1f}cm³) without significant mass effect currently"
            )
            signs.append("Recommend close monitoring for interval mass effect development")
        else:
            signs.append("No significant herniation risk - no measurable mass effect")

    return {
        "risk_level": level,
        "herniation_signs": signs,
        "risk_factors": risk_factors,
        "mass_effect_score": float(score),
        "mass_effect_metrics": {
            "midline_shift_mm": float(shift),
            "midline_shift_significant": midline.get("is_significant", False),
            "ventricular_asymmetry": float(asym),
            "ventricular_severity": ventricular.get("severity", "None/Minimal"),
            "sulcal_effacement_severity": sulcal_sev,
        },
        "tumor_volume_cm3": float(tumor_volume_cm3),
        "clinical_note": "Risk derived from measurable displacement metrics, not tumor proximity alone",
    }


def determine_anatomical_location(ctx: FeatureContext) -> Dict:
    tumor = ctx.tumor_masks["wt"]
    dims = ctx.shape
    if tumor.sum() == 0:
        return {
            "hemisphere": "None",
            "laterality": "N/A",
            "lobes": [],
            "primary_lobe": "None",
            "depth": "No tumor detected",
            "approximate_gyri": [],
            "details": "No tumor present",
        }
    total = int(tumor.sum())
    centroid = _centroid(tumor)
    bbox = _bounding_box(tumor)

    mid = int(dims[0] / 2)
    left = int(tumor[:mid].sum())
    right = int(tumor[mid:].sum())
    if left > 0.9 * total:
        hemisphere, laterality = "left", "Unilateral (left hemisphere)"
    elif right > 0.9 * total:
        hemisphere, laterality = "right", "Unilateral (right hemisphere)"
    elif left > 0.6 * total:
        hemisphere, laterality = "left-predominant", "Bilateral, left-predominant"
    elif right > 0.6 * total:
        hemisphere, laterality = "right-predominant", "Bilateral, right-predominant"
    else:
        hemisphere, laterality = "bilateral", "Bilateral (crosses midline)"

    # fractional-bbox lobe masks (atlas-free approximation, ref :471-524)
    def box_overlap(xs=slice(None), ys=slice(None), zs=slice(None)):
        return int(tumor[xs, ys, zs].sum())

    lobes: List[str] = []
    pcts: Dict[str, float] = {}
    details: Dict[str, str] = {}

    frontal = box_overlap(ys=slice(0, int(dims[1] * 0.45)), zs=slice(int(dims[2] * 0.3), None))
    if frontal > 0.05 * total:
        lobes.append("frontal")
        pcts["frontal"] = frontal / total * 100
        details["frontal"] = f"{pcts['frontal']:.0f}% of tumor in frontal lobe"

    parietal = box_overlap(
        ys=slice(int(dims[1] * 0.3), int(dims[1] * 0.7)), zs=slice(int(dims[2] * 0.5), None)
    )
    if parietal > 0.05 * total:
        lobes.append("parietal")
        pcts["parietal"] = parietal / total * 100
        details["parietal"] = f"{pcts['parietal']:.0f}% of tumor in parietal lobe"

    temporal = box_overlap(
        xs=slice(0, int(dims[0] * 0.35)),
        ys=slice(int(dims[1] * 0.2), int(dims[1] * 0.7)),
        zs=slice(0, int(dims[2] * 0.55)),
    ) + box_overlap(
        xs=slice(int(dims[0] * 0.65), None),
        ys=slice(int(dims[1] * 0.2), int(dims[1] * 0.7)),
        zs=slice(0, int(dims[2] * 0.55)),
    )
    if temporal > 0.05 * total:
        lobes.append("temporal")
        pcts["temporal"] = temporal / total * 100
        details["temporal"] = f"{pcts['temporal']:.0f}% of tumor in temporal lobe"

    occipital = box_overlap(ys=slice(int(dims[1] * 0.65), None))
    if occipital > 0.05 * total:
        lobes.append("occipital")
        pcts["occipital"] = occipital / total * 100
        details["occipital"] = f"{pcts['occipital']:.0f}% of tumor in occipital lobe"

    deep = box_overlap(
        xs=slice(int(dims[0] * 0.3), int(dims[0] * 0.7)),
        ys=slice(int(dims[1] * 0.3), int(dims[1] * 0.6)),
        zs=slice(int(dims[2] * 0.25), int(dims[2] * 0.6)),
    )
    if deep > 0.1 * total:
        lobes.append("deep structures")
        pcts["deep_structures"] = deep / total * 100
        details["deep_structures"] = (
            f"{pcts['deep_structures']:.0f}% involving deep structures (basal ganglia/thalamus)"
        )

    if pcts:
        primary = max(pcts, key=pcts.get)
        primary_pct = pcts[primary]
    else:
        primary, primary_pct = "indeterminate", 0
        lobes = ["location indeterminate"]

    center = np.array(dims) / 2
    tc = np.array([centroid["x"], centroid["y"], centroid["z"]])
    dist = float(np.linalg.norm((tc - center) * np.array(ctx.zooms)))
    brain_radius = min(dims) * min(ctx.zooms) / 2
    relative_depth = 1 - dist / brain_radius
    if relative_depth > 0.7:
        depth = "Deep (periventricular/central)"
        depth_detail = "Tumor located in deep brain structures near ventricles"
    elif relative_depth > 0.4:
        depth = "Subcortical"
        depth_detail = "Tumor located in subcortical white matter"
    else:
        depth = "Cortical/Superficial"
        depth_detail = "Tumor involves cortical surface or is superficially located"

    gyri: List[str] = []
    cz = centroid["z"]
    if "frontal" in lobes:
        if cz > dims[2] * 0.7:
            gyri.append("superior frontal gyrus region")
        elif cz > dims[2] * 0.5:
            gyri.append("middle frontal gyrus region")
        else:
            gyri.append("inferior frontal gyrus region")
    if "parietal" in lobes:
        gyri.append(
            "superior parietal lobule region" if cz > dims[2] * 0.65 else "inferior parietal lobule region"
        )
    if "temporal" in lobes:
        if cz > dims[2] * 0.45:
            gyri.append("superior temporal gyrus region")
        elif cz > dims[2] * 0.3:
            gyri.append("middle temporal gyrus region")
        else:
            gyri.append("inferior temporal gyrus region")
    if "occipital" in lobes:
        gyri.append("occipital cortex region")
    if not gyri:
        gyri = ["gyral localization not determined"]

    return {
        "hemisphere": hemisphere,
        "laterality": laterality,
        "lobes": lobes,
        "lobe_percentages": pcts,
        "lobe_details": details,
        "primary_lobe": primary,
        "primary_lobe_percentage": float(primary_pct),
        "depth": depth,
        "depth_detail": depth_detail,
        "relative_depth_score": float(relative_depth),
        "approximate_gyri": gyri,
        "tumor_centroid": centroid,
        "tumor_bounding_box": bbox,
        "note": "Anatomical localization estimated from standard brain atlas coordinates - clinical correlation recommended",
    }


def _text_summary(results: Dict) -> str:
    lines = ["MASS EFFECT ANALYSIS:", "", "Anatomical Location:"]
    loc = results["anatomical_location"]
    lines.append(f"  - Laterality: {loc['laterality']}")
    lines.append(
        f"  - Primary lobe: {loc['primary_lobe'].capitalize()} "
        f"({loc.get('primary_lobe_percentage', 0):.0f}%)"
    )
    if len(loc["lobes"]) > 1:
        extra = ", ".join(l for l in loc["lobes"] if l != loc["primary_lobe"])
        lines.append(f"  - Additional involvement: {extra}")
    lines.append(f"  - Depth: {loc['depth']}")
    gyri = loc.get("approximate_gyri") or []
    if gyri and gyri[0] != "gyral localization not determined":
        lines.append(f"  - Gyri (estimated): {', '.join(gyri)}")
    lines.append("")
    ms = results["midline_shift"]
    if ms["is_significant"]:
        lines.append(f"Midline Shift: {ms['severity']} ({ms['shift_mm']:.1f} mm)")
        lines.append(f"  - Direction: {ms['shift_direction']}")
    else:
        lines.append("Midline Shift: None")
        lines.append("  - No significant midline shift detected")
    lines.append(f"  - Tumor hemisphere: {ms.get('tumor_hemisphere', 'N/A')}")
    lines.append("")
    vc = results["ventricular_compression"]
    lines.append(f"Ventricular System: {vc['severity']}")
    if vc["compression_detected"]:
        lines.append(f"  - Compressed side: {vc['compressed_side']}")
        lines.append(f"  - Asymmetry ratio: {vc['asymmetry_ratio']:.2f}")
    if vc.get("tumor_to_ventricle_distance_mm"):
        lines.append(f"  - Tumor-ventricle distance: {vc['tumor_to_ventricle_distance_mm']:.1f} mm")
    lines.append("")
    lines.append(f"Sulcal Effacement: {results['sulcal_effacement']['severity']}")
    lines.append("")
    hr = results["herniation_risk"]
    lines.append(f"Herniation Risk Assessment: {hr['risk_level']}")
    lines.append(f"  - Mass effect score: {hr['mass_effect_score']:.1f}/7")
    for sign in hr["herniation_signs"]:
        lines.append(f"  - {sign}")
    return "\n".join(lines)


def analyze_mass_effect(ctx: FeatureContext) -> Dict:
    """Run step 2 on a loaded case; returns the reference-schema dict."""
    location = determine_anatomical_location(ctx)
    midline = calculate_midline_shift(ctx)
    ventricular = analyze_ventricular_compression(ctx)
    sulcal = analyze_sulcal_effacement(ctx)
    tumor_volume = ctx.region_volume_cm3("wt")
    herniation = assess_herniation_risk(midline, ventricular, sulcal, tumor_volume)

    results = {
        "case_id": ctx.case_id,
        "step": "Step 2 - Mass effect metrics",
        "voxel_info": ctx.voxel_info(),
        "anatomical_location": location,
        "midline_shift": midline,
        "ventricular_compression": ventricular,
        "sulcal_effacement": sulcal,
        "herniation_risk": herniation,
    }
    results["text_summary"] = _text_summary(results)
    return results
