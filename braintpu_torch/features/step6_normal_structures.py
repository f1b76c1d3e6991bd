"""Feature step 6: normal-structures assessment.

Semantics-parity re-implementation of
upstream feature_extraction/step6_normal_structures.py:
* ventricle segmentation by multi-sequence CSF criteria (T1 < p15,
  T2 > p85, FLAIR < p25 within brain, tumor excluded), morphological
  open, >1 cm³ central components (ref :33-84),
* VBR with 2/4/6 % size bins, L/R asymmetry, Evans-index estimate,
  hydrocephalus call (Evans > 0.3 ∧ VBR > 5, or VBR > 7), obstruction risk
  via tumor dilation overlap (ref :87-185),
* parenchyma: periventricular FLAIR hyperintensity ratio (1.15/1.3 bins),
  gray-white differentiation via deep-WM/cortical T1 ratio (ref :188-289),
* vessels: inferior-brain flow-void heuristic + peritumoral enhancement
  ratio > 1.5 (ref :292-386).

Fixed here (latent reference bug): the cortical mask is computed
unconditionally; the reference only defines it inside the periventricular
branch and would NameError when that region is empty (ref :224 vs :248).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import ndimage

from .boxops import bbox_slices, binary_dilation_bbox, binary_erosion_bbox, edt

from .context import FeatureContext

__all__ = ["identify_ventricles", "analyze_normal_structures"]


def identify_ventricles(ctx: FeatureContext) -> Tuple[np.ndarray, np.ndarray]:
    """CSF/ventricle masks from multi-sequence criteria. Returns (ventricles, csf).

    Cached per context: both analyze_ventricular_system and
    analyze_parenchyma need it, and the percentile + connected-component
    pass is one of the heavier host computations in step 6.
    """
    cached = getattr(ctx, "_ventricle_masks", None)
    if cached is not None:
        return cached
    t1, t2, flair = ctx.modalities["t1"], ctx.modalities["t2"], ctx.modalities["flair"]
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]

    t1_low = np.percentile(t1[brain], 15)
    t2_high = np.percentile(t2[brain], 85)
    flair_low = np.percentile(flair[brain], 25)

    csf = brain & (t1 < t1_low) & (t2 > t2_high) & (flair < flair_low) & ~tumor
    csf = binary_dilation_bbox(binary_erosion_bbox(csf, iterations=1), iterations=1)

    structure = ndimage.generate_binary_structure(3, 2)
    ventricles = np.zeros_like(csf)
    min_size = 1000  # 1 cm³ at 1 mm³ voxels
    center_x = brain.shape[0] / 2
    sl = bbox_slices(csf)  # CC labeling on the CSF box; exact (no
    if sl is not None:     # component extends past its mask's bbox)
        csf_b = csf[sl]
        labeled, n = ndimage.label(csf_b, structure=structure)
        if n:
            # all component sizes + x-centroids in ONE pass each (the
            # previous per-component `labeled == i` + nonzero loop scanned
            # the grid once per component)
            flat = labeled.ravel()
            sizes = np.bincount(flat)
            xidx = np.arange(sl[0].start, sl[0].stop, dtype=np.float64)
            xw = np.bincount(
                flat,
                weights=np.broadcast_to(
                    xidx[:, None, None], labeled.shape
                ).ravel(),
            )
            with np.errstate(invalid="ignore"):
                centx = xw / sizes  # label 0 may be 0/0 — never selected
            keep = np.zeros(n + 1, bool)
            keep[1:] = (sizes[1:] > min_size) & (
                np.abs(centx[1:] - center_x) < brain.shape[0] * 0.3
            )
            ventricles[sl] = keep[labeled]
    ctx._ventricle_masks = (ventricles, csf)
    return ventricles, csf


def analyze_ventricular_system(ctx: FeatureContext) -> Dict:
    ventricles, _ = identify_ventricles(ctx)
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]
    v = ctx.voxel_volume_cm3

    total = float(ventricles.sum() * v)
    brain_volume = float((brain & ~tumor).sum() * v)
    vbr = total / brain_volume * 100 if brain_volume > 0 else 0.0

    mid = ventricles.shape[0] // 2
    left = float(ventricles[:mid].sum() * v)
    right = float(ventricles[mid:].sum() * v)
    asym = abs(left - right) / (left + right) if (left + right) > 0 else 0.0
    larger = "left" if left > right else "right" if right > left else "symmetric"

    coords = np.nonzero(ventricles)
    if coords[1].size > 0:
        frontal_y = np.percentile(coords[1], 75)
        frontal = ventricles[:, int(frontal_y) :, :]
        frontal_width = int(np.max(np.sum(frontal, axis=0))) if frontal.any() else 0
        evans = frontal_width / brain.shape[0]
    else:
        evans = 0.0

    if evans > 0.3 and vbr > 5:
        hydro, hydro_type = True, "Communicating hydrocephalus suggested"
    elif vbr > 7:
        hydro, hydro_type = True, "Ventriculomegaly noted"
    else:
        hydro, hydro_type = False, "No hydrocephalus"

    tumor_dilated = ctx.dilated_wt(5)
    near = ventricles & tumor_dilated
    obstruction = float(near.sum() / ventricles.sum()) if ventricles.sum() > 0 else 0.0

    if vbr < 2:
        size_assess, size_note = "Normal", "Ventricles within normal size limits"
    elif vbr < 4:
        size_assess, size_note = "Mildly prominent", "Mild prominence of ventricular system"
    elif vbr < 6:
        size_assess, size_note = "Moderately dilated", "Moderate ventricular enlargement"
    else:
        size_assess, size_note = "Markedly dilated", "Marked ventriculomegaly"

    return {
        "total_volume_cm3": total,
        "left_volume_cm3": left,
        "right_volume_cm3": right,
        "ventricle_brain_ratio_percent": float(vbr),
        "asymmetry_index": float(asym),
        "larger_side": larger,
        "evans_index_estimate": float(evans),
        "size_assessment": size_assess,
        "size_note": size_note,
        "hydrocephalus_present": hydro,
        "hydrocephalus_type": hydro_type,
        "obstruction_risk": obstruction,
        "obstruction_note": "Tumor adjacent to ventricular system"
        if obstruction > 0.1
        else "No direct ventricular involvement",
        "symmetry_assessment": "Symmetric" if asym < 0.15 else f"Asymmetric ({larger} larger)",
    }


def analyze_parenchyma(ctx: FeatureContext) -> Dict:
    t1, flair = ctx.modalities["t1"], ctx.modalities["flair"]
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]
    normal = brain & ~tumor
    if normal.sum() == 0:
        return {
            "assessment": "Unable to assess",
            "note": "Insufficient normal brain tissue for analysis",
            # keys the text summary renders unconditionally
            "periventricular_assessment": {
                "white_matter_disease": False,
                "description": "Could not assess",
            },
            "gray_white_differentiation": {
                "assessment": "Could not assess",
                "note": "Insufficient normal brain tissue for analysis",
            },
            "overall_assessment": "Could not assess",
        }
    v = ctx.voxel_volume_cm3

    # EDT cropped to the brain bbox +1: everything outside a tight
    # brain box is background in the full volume too, and the +1 ring
    # (clipped at true volume faces, where full-volume EDT also sees
    # no further background) preserves exact distances — ~2.4x fewer
    # voxels than the full grid, and every consumer below only reads
    # in-box voxels.
    sl = bbox_slices(brain, pad=1)
    brain_b = brain[sl]
    normal_b, t1_b, flair_b = normal[sl], t1[sl], flair[sl]
    brain_dist = edt(brain_b)
    in_brain_dist = brain_dist[brain_b]
    cort_thr, deep_thr = np.percentile(in_brain_dist, [40, 60])
    deep_wm = normal_b & (brain_dist > deep_thr)
    cortical = normal_b & (brain_dist < cort_thr)
    deep_count, cortical_count = int(deep_wm.sum()), int(cortical.sum())
    deep_t1_mean = float(t1_b[deep_wm].mean()) if deep_count else 0.0
    cort_t1_mean = float(t1_b[cortical].mean()) if cortical_count else 0.0
    cort_flair_mean = float(flair_b[cortical].mean()) if cortical_count else 0.0
    normal_count, brain_count = int(normal.sum()), int(brain.sum())

    ventricles, _ = identify_ventricles(ctx)
    pv = binary_dilation_bbox(ventricles, iterations=10) & normal & ~ventricles

    if pv.sum() > 0 and cortical_count > 0:
        pv_mean = float(flair[pv].mean())
        cort_mean = cort_flair_mean
        pv_ratio = pv_mean / cort_mean if cort_mean > 0 else 1.0
        if pv_ratio > 1.3:
            wm_disease, wm_desc = True, (
                "FLAIR hyperintensities in periventricular white matter, may represent "
                "chronic small vessel disease"
            )
        elif pv_ratio > 1.15:
            wm_disease, wm_desc = True, "Mild periventricular FLAIR signal changes"
        else:
            wm_disease, wm_desc = False, "No significant periventricular white matter changes"
    else:
        pv_ratio, wm_disease = 1.0, False
        wm_desc = "Periventricular region could not be assessed"

    if deep_count > 100:
        deep_t1 = deep_t1_mean
        cort_t1 = cort_t1_mean if cortical_count > 100 else deep_t1
        gw_ratio = deep_t1 / cort_t1 if cort_t1 > 0 else 1.0
        if gw_ratio > 1.1:
            gw, gw_note = "Preserved", "Normal gray-white matter differentiation"
        elif gw_ratio > 1.0:
            gw, gw_note = "Mildly reduced", "Slightly reduced gray-white differentiation"
        else:
            gw, gw_note = "Reduced", (
                "Loss of gray-white differentiation (may indicate edema or diffuse pathology)"
            )
    else:
        gw, gw_ratio, gw_note = "Could not assess", 1.0, "Insufficient tissue for gray-white analysis"

    return {
        "normal_brain_volume_cm3": float(normal_count * v),
        "total_brain_volume_cm3": float(brain_count * v),
        "periventricular_assessment": {
            "hyperintensity_ratio": float(pv_ratio),
            "white_matter_disease_present": wm_disease,
            "description": wm_desc,
        },
        "gray_white_differentiation": {
            "assessment": gw,
            "ratio": float(gw_ratio),
            "note": gw_note,
        },
        "overall_assessment": "Normal"
        if not wm_disease and gw == "Preserved"
        else "Abnormal findings present",
        "atrophy_assessment": "Not formally assessed (requires age-matched normative data)",
    }


def analyze_major_vessels(ctx: FeatureContext) -> Dict:
    t1, t1ce = ctx.modalities["t1"], ctx.modalities.get("t1ce")
    brain = ctx.brain_mask("t1")
    tumor = ctx.tumor_masks["wt"]

    inferior_third = brain.shape[2] // 3
    inferior = brain.copy()
    inferior[:, :, inferior_third:] = False

    if inferior.sum() > 0:
        thr = np.percentile(t1[inferior], 5)
        flow_void = inferior & (t1 < thr) & ~tumor
        fv_volume = float(flow_void.sum() * ctx.voxel_volume_cm3)
        fv_fraction = float(flow_void.sum() / inferior.sum())
        if 0.001 < fv_fraction < 0.05:
            fv_assess, fv_note = "Present", "Flow voids identified in expected vessel locations"
        elif fv_fraction < 0.001:
            fv_assess = "Not well visualized"
            fv_note = (
                "Major vessel flow voids not clearly identified "
                "(may be normal variant or sequence-dependent)"
            )
        else:
            fv_assess = "Prominent"
            fv_note = (
                "Prominent dark signal in basal regions "
                "(may include vessels and air-bone interfaces)"
            )
    else:
        fv_assess, fv_note = "Could not assess", "Insufficient inferior brain for vessel assessment"
        fv_volume = 0.0

    if t1ce is not None:
        peri = ctx.dilated_wt(10) & ~tumor & brain
        if peri.sum() > 0:
            p_t1 = float(t1[peri].mean())
            p_t1ce = float(t1ce[peri].mean())
            ratio = p_t1ce / p_t1 if p_t1 > 0 else 1.0
            if ratio > 1.5:
                vi, vi_note = "Possible", (
                    "Enhancement in peritumoral region may indicate vascular involvement"
                )
            else:
                vi, vi_note = "Not evident", "No obvious vascular encasement or involvement"
        else:
            vi, vi_note, ratio = "Could not assess", "Insufficient peritumoral tissue", 1.0
    else:
        vi, vi_note, ratio = "Not assessed", "T1ce not available for enhancement assessment", 0.0

    return {
        "flow_voids": {"assessment": fv_assess, "note": fv_note, "volume_cm3": fv_volume},
        "vascular_involvement": {
            "assessment": vi,
            "note": vi_note,
            "peritumoral_enhancement_ratio": float(ratio) if t1ce is not None else None,
        },
        "limitations": [
            "Detailed vascular assessment requires MRA/MRV sequences",
            "Flow void analysis is limited on standard structural MRI",
            "Cannot assess vessel patency or flow direction",
        ],
        "overall_assessment": "Limited assessment on structural sequences",
    }


def _text_summary(results: Dict) -> str:
    lines = ["NORMAL STRUCTURES ASSESSMENT:", "", "Ventricular System:"]
    vent = results["ventricular_system"]
    lines += [
        f"  - Size: {vent['size_assessment']} (VBR: {vent['ventricle_brain_ratio_percent']:.1f}%)",
        f"  - Volume: {vent['total_volume_cm3']:.1f} cm³ (L: {vent['left_volume_cm3']:.1f}, R: {vent['right_volume_cm3']:.1f})",
        f"  - Symmetry: {vent['symmetry_assessment']}",
        f"  - {vent['hydrocephalus_type']}",
    ]
    if vent["obstruction_risk"] > 0.1:
        lines.append(f"  - ⚠ {vent['obstruction_note']}")
    par = results["parenchyma"]
    lines += [
        "",
        "Brain Parenchyma:",
        f"  - Gray-white differentiation: {par['gray_white_differentiation']['assessment']}",
        f"    {par['gray_white_differentiation']['note']}",
        f"  - Periventricular white matter: {par['periventricular_assessment']['description']}",
        f"  - Overall: {par['overall_assessment']}",
    ]
    ves = results["major_vessels"]
    lines += [
        "",
        "Major Vessels (Limited Assessment):",
        f"  - Flow voids: {ves['flow_voids']['assessment']}",
        f"  - Vascular involvement: {ves['vascular_involvement']['assessment']}",
        f"  Note: {ves['overall_assessment']}",
    ]
    return "\n".join(lines)


def analyze_normal_structures(ctx: FeatureContext) -> Dict:
    """Run step 6 on a loaded case; returns the reference-schema dict."""
    results = {
        "case_id": ctx.case_id,
        "step": "Step 6 - Normal structures assessment",
        "voxel_info": ctx.voxel_info(),
        "ventricular_system": analyze_ventricular_system(ctx),
        "parenchyma": analyze_parenchyma(ctx),
        "major_vessels": analyze_major_vessels(ctx),
    }
    results["text_summary"] = _text_summary(results)
    return results
