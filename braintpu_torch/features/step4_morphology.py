"""Feature step 4: tumor morphology & margins.

Semantics-parity re-implementation of
upstream feature_extraction/step4_morphology.py:
* surface area via erosion-boundary voxel count × mean face area (ref :33-55),
* sphericity (equivalent-sphere surface / actual, clamped to [0,1], ref :58-75),
* compactness 36πV²/S³ (ref :118-130),
* PCA elongation + 2σ principal axis lengths (ref :78-115),
* contour regularity from the CV of the signed-distance-gradient magnitude
  on surface voxels, bins 0.3/0.5/0.7 (ref :133-205),
* margin sharpness = (peritumoral T1ce contrast + normalized border
  gradient) / 2, bins 0.2/0.4/0.6 (ref :208-290),
* cystic-vs-solid via multi-sequence CSF-likeness of the NCR region with the
  10/85/20-percentile CSF references and 15/40/70 % classification bins
  (ref :293-397),
* necrosis percentage/location pattern with 10/25/50 % bins and
  0.3/0.6-radius centrality (ref :400-480),
* explicit contour-vs-margin concept separation (``concept`` fields,
  ref :204, :289).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .boxops import bbox_slices, binary_dilation_bbox, binary_erosion_bbox, edt
from .context import FeatureContext

__all__ = ["analyze_morphology"]


def calculate_surface_area(mask: np.ndarray, voxel_dims) -> float:
    if mask.sum() == 0:
        return 0.0
    surface = mask & ~binary_erosion_bbox(mask)
    avg_face = (
        voxel_dims[0] * voxel_dims[1]
        + voxel_dims[1] * voxel_dims[2]
        + voxel_dims[0] * voxel_dims[2]
    ) / 3
    return float(surface.sum() * avg_face)


def calculate_sphericity(volume_mm3: float, surface_area_mm2: float) -> float:
    if surface_area_mm2 == 0 or volume_mm3 == 0:
        return 0.0
    radius = (3 * volume_mm3 / (4 * np.pi)) ** (1 / 3)
    sphere_surface = 4 * np.pi * radius**2
    return float(np.clip(sphere_surface / surface_area_mm2, 0.0, 1.0))


def calculate_compactness(volume_mm3: float, surface_area_mm2: float) -> float:
    if surface_area_mm2 == 0:
        return 0.0
    return float(min(1.0, 36 * np.pi * volume_mm3**2 / surface_area_mm2**3))


def calculate_elongation(mask: np.ndarray, voxel_dims) -> Tuple[float, List[float]]:
    coords = np.nonzero(mask)
    if len(coords[0]) < 10:
        return 1.0, [1.0, 1.0, 1.0]
    points = np.stack(
        [coords[i] * voxel_dims[i] for i in range(3)], axis=1
    ).astype(np.float64)
    centered = points - points.mean(axis=0)
    cov = np.cov(centered.T)
    eig = np.sort(np.linalg.eigvalsh(cov))[::-1]
    elongation = float(np.sqrt(eig[0] / eig[-1])) if eig[-1] > 0 else 1.0
    axes = [float(np.sqrt(max(e, 0.0)) * 2) for e in eig]
    return elongation, axes


def analyze_border_regularity(
    mask: np.ndarray, ctx: FeatureContext | None = None
) -> Dict:
    if mask.sum() == 0:
        return {"regularity_score": 0, "classification": "No tumor", "description": "No tumor detected"}
    surface = mask & ~binary_erosion_bbox(mask)
    surf_count = int(surface.sum())
    if surf_count >= 10:
        # signed-EDT gradients are consumed ONLY at surface voxels,
        # whose distances to the boundary are <=1 voxel — a box padded
        # by 4 (1 for the distance + 2 for np.gradient's stencil +
        # margin) is exact, and ~25x less EDT work than the full grid
        sl = bbox_slices(mask, pad=4)
        msk = mask[sl]
        signed = edt(msk) - edt(~msk)
        grads = np.gradient(signed)
        grad_mag = np.sqrt(grads[0] ** 2 + grads[1] ** 2 + grads[2] ** 2)
        surf_grad = grad_mag[surface[sl]]
        g_mean, g_std = float(surf_grad.mean()), float(surf_grad.std())
    else:
        g_mean = g_std = 0.0
    if surf_count < 10:
        return {
            "regularity_score": 1.0,
            "classification": "Too small to assess",
            "description": "Tumor too small for border analysis",
        }
    if g_std > 0:
        cv = g_std / g_mean
        regularity = 1.0 / (1.0 + cv)
    else:
        regularity = 1.0
    if regularity > 0.7:
        classification = "Smooth contour"
        description = "Smooth, regular outer contour (note: does not indicate margin sharpness)"
    elif regularity > 0.5:
        classification = "Mildly lobulated"
        description = "Some contour irregularity with mild lobulation"
    elif regularity > 0.3:
        classification = "Lobulated"
        description = "Lobulated/irregular outer contour"
    else:
        classification = "Highly irregular"
        description = "Highly irregular/spiculated outer contour"
    return {
        "regularity_score": float(regularity),
        "classification": classification,
        "description": description,
        "surface_voxel_count": surf_count,
        "concept": "contour_smoothness",
    }


def analyze_margin_definition(ctx: FeatureContext) -> Dict:
    t1ce = ctx.modalities["t1ce"]
    wt = ctx.tumor_masks["wt"]
    if wt.sum() == 0:
        return {"margin_sharpness": 0, "classification": "No tumor", "description": "No tumor detected"}
    dilated = ctx.dilated_wt(5)
    peritumoral = dilated & ~wt
    peri_n = int(peritumoral.sum())
    tumor_mean = float(t1ce[wt].mean())
    peri_mean = float(t1ce[peritumoral].mean()) if peri_n else 0.0
    inner = wt & ~binary_erosion_bbox(wt)
    outer = binary_dilation_bbox(wt) & ~wt
    iv, ov = t1ce[inner], t1ce[outer]
    inner_n, outer_n = iv.size, ov.size
    i_mean = float(iv.mean()) if inner_n else 0.0
    i_std = float(iv.std()) if inner_n else 0.0
    o_mean = float(ov.mean()) if outer_n else 0.0
    o_std = float(ov.std()) if outer_n else 0.0
    if peri_n == 0:
        return {
            "margin_sharpness": 0.5,
            "classification": "Could not assess",
            "description": "Insufficient peritumoral tissue for analysis",
        }
    contrast = abs(tumor_mean - peri_mean) / peri_mean if peri_mean > 0 else 0.0
    if inner_n > 0 and outer_n > 0:
        border_gradient = abs(i_mean - o_mean)
        border_gradient_norm = border_gradient / (i_std + o_std + 1e-6)
    else:
        border_gradient_norm = 0.0
    sharpness = min(1.0, (contrast + border_gradient_norm) / 2)
    if sharpness > 0.6:
        classification = "Sharp transition"
        description = "Abrupt tumor-brain intensity transition, well-demarcated margin"
    elif sharpness > 0.4:
        classification = "Moderate transition"
        description = "Moderately distinct margin with some gradual transition zones"
    elif sharpness > 0.2:
        classification = "Gradual transition"
        description = "Indistinct margin with gradual intensity blending into brain"
    else:
        classification = "Infiltrative transition"
        description = "No clear intensity demarcation, tumor infiltrates surrounding parenchyma"
    return {
        "margin_sharpness": float(sharpness),
        "contrast_ratio": float(contrast),
        "border_gradient": float(border_gradient_norm),
        "classification": classification,
        "description": description,
        "concept": "intensity_transition",
    }


def analyze_cystic_vs_solid(ctx: FeatureContext) -> Dict:
    t1 = ctx.modalities["t1"]
    t2 = ctx.modalities["t2"]
    flair = ctx.modalities["flair"]
    masks = ctx.tumor_masks
    ncr, wt = masks["ncr"], masks["wt"]
    if wt.sum() == 0:
        return {
            "classification": "No tumor",
            "cystic_percentage": 0,
            "solid_percentage": 0,
            "description": "No tumor detected",
        }
    voxel_cm3 = ctx.voxel_volume_cm3

    def _pos_percentile(vol, q):
        # a blank/corrupt modality has no positive voxels; np.percentile on
        # the empty array would abort feature extraction for the whole case
        pos = vol[vol > 0]
        return float(np.percentile(pos, q)) if pos.size else 0.0

    csf_t1_upper = _pos_percentile(t1, 10)
    csf_t2_lower = _pos_percentile(t2, 85)
    csf_flair_upper = _pos_percentile(flair, 20)

    if ncr.sum() > 0:
        nt1, nt2, nfl = t1[ncr], t2[ncr], flair[ncr]
        cystic_like = (
            (nt1 < csf_t1_upper * 1.5) & (nt2 > csf_t2_lower * 0.8) & (nfl < csf_flair_upper * 2)
        )
        cystic_fraction = float(cystic_like.sum() / nt1.size)
        t2_cv = float(nt2.std() / nt2.mean()) if nt2.mean() > 0 else 0.0
        flair_t2_ratio = float(nfl.mean() / nt2.mean()) if nt2.mean() > 0 else 1.0
    else:
        cystic_fraction, t2_cv, flair_t2_ratio = 0.0, 0.0, 1.0

    ncr_volume = float(ncr.sum() * voxel_cm3)
    wt_volume = float(wt.sum() * voxel_cm3)
    cystic_volume = ncr_volume * cystic_fraction
    cystic_pct = cystic_volume / wt_volume * 100 if wt_volume > 0 else 0.0
    solid_volume = wt_volume - cystic_volume
    solid_pct = 100 - cystic_pct

    if cystic_pct > 70:
        classification = "Predominantly cystic"
        description = "Large cystic component with thin wall/rim"
    elif cystic_pct > 40:
        classification = "Cystic with solid component"
        description = "Mixed cystic and solid tumor with significant cystic component"
    elif cystic_pct > 15:
        classification = "Solid with cystic component"
        description = "Predominantly solid tumor with cystic/necrotic areas"
    elif ncr.sum() > 0:
        if t2_cv > 0.3:
            classification = "Solid with necrosis"
            description = "Solid tumor with central necrotic (non-cystic) component"
        else:
            classification = "Solid with possible cyst"
            description = "Solid tumor with possible small cystic component"
    else:
        classification = "Solid"
        description = "Homogeneous solid tumor without significant cystic component"

    signal_characteristics = {
        "t2_homogeneity": "Homogeneous"
        if t2_cv < 0.2
        else ("Mildly heterogeneous" if t2_cv < 0.4 else "Heterogeneous"),
        "flair_suppression": "Present (suggests true cyst)"
        if flair_t2_ratio < 0.7
        else "Absent (suggests necrosis/protein)",
        "csf_like_signal_fraction": cystic_fraction,
    }
    return {
        "classification": classification,
        "cystic_volume_cm3": float(cystic_volume),
        "cystic_percentage": float(cystic_pct),
        "solid_volume_cm3": float(solid_volume),
        "solid_percentage": float(solid_pct),
        "signal_characteristics": signal_characteristics,
        "description": description,
    }


def analyze_necrosis_pattern(ctx: FeatureContext) -> Dict:
    masks = ctx.tumor_masks
    ncr, tc, wt = masks["ncr"], masks["tc"], masks["wt"]
    v = ctx.voxel_volume_cm3
    ncr_volume = float(ncr.sum() * v)
    tc_volume = float(tc.sum() * v)
    wt_volume = float(wt.sum() * v)
    if wt_volume == 0:
        return {"necrosis_present": False, "pattern": "No tumor", "description": "No tumor detected"}
    if ncr_volume == 0:
        return {
            "necrosis_present": False,
            "necrosis_volume_cm3": 0,
            "necrosis_percentage": 0,
            "pattern": "No necrosis",
            "description": "No central necrosis identified, solid tumor",
        }
    pct = ncr_volume / wt_volume * 100

    if ncr.sum() > 0 and tc.sum() > 0:
        ncr_c = np.array([c.mean() for c in np.nonzero(ncr)])
        tc_c = np.array([c.mean() for c in np.nonzero(tc)])
        dist = float(np.linalg.norm((ncr_c - tc_c) * np.array(ctx.zooms)))
        tc_radius = (3 * tc_volume * 1000 / (4 * np.pi)) ** (1 / 3)
        if dist < tc_radius * 0.3:
            location, location_description = "Central", "Necrosis centered within tumor"
        elif dist < tc_radius * 0.6:
            location, location_description = "Eccentric", "Necrosis somewhat offset from tumor center"
        else:
            location, location_description = "Peripheral", "Necrosis located eccentrically"
    else:
        location, location_description = "Undetermined", "Could not determine necrosis location"

    if pct > 50:
        pattern = "Extensive necrosis"
        description = (
            f"Large central necrotic component ({pct:.0f}% of tumor), characteristic of high-grade glioma"
        )
    elif pct > 25:
        pattern = "Moderate necrosis"
        description = f"Moderate central necrosis ({pct:.0f}% of tumor), suggests high-grade pathology"
    elif pct > 10:
        pattern = "Focal necrosis"
        description = f"Focal areas of necrosis ({pct:.0f}% of tumor)"
    else:
        pattern = "Minimal necrosis"
        description = f"Small necrotic foci ({pct:.0f}% of tumor)"

    return {
        "necrosis_present": True,
        "necrosis_volume_cm3": ncr_volume,
        "necrosis_percentage": float(pct),
        "pattern": pattern,
        "location": location,
        "location_description": location_description,
        "description": description,
    }


def calculate_shape_descriptors(ctx: FeatureContext) -> Dict:
    wt = ctx.tumor_masks["wt"]
    if wt.sum() == 0:
        return {
            "volume_cm3": 0,
            "surface_area_mm2": 0,
            "sphericity": 0,
            "compactness": 0,
            "elongation": 1.0,
            "principal_axes_mm": [0, 0, 0],
            # keys the text summary renders unconditionally
            "shape_classification": "No tumor",
            "elongation_classification": "No tumor",
        }
    volume_mm3 = float(wt.sum() * ctx.voxel_volume_mm3)
    surface = calculate_surface_area(wt, ctx.zooms)
    sphericity = calculate_sphericity(volume_mm3, surface)
    compactness = calculate_compactness(volume_mm3, surface)
    elongation, axes = calculate_elongation(wt, ctx.zooms)

    if sphericity > 0.8:
        shape_class = "Spherical/round"
    elif sphericity > 0.6:
        shape_class = "Ovoid"
    elif sphericity > 0.4:
        shape_class = "Irregular"
    else:
        shape_class = "Highly irregular/complex"
    if elongation > 2.5:
        elong_class = "Elongated"
    elif elongation > 1.5:
        elong_class = "Mildly elongated"
    else:
        elong_class = "Roughly isotropic"
    return {
        "volume_cm3": volume_mm3 / 1000,
        "surface_area_mm2": surface,
        "sphericity": sphericity,
        "compactness": compactness,
        "elongation": elongation,
        "principal_axes_mm": axes,
        "shape_classification": shape_class,
        "elongation_classification": elong_class,
    }


def _text_summary(results: Dict) -> str:
    lines = ["TUMOR MORPHOLOGY AND MARGINS:", ""]
    shape = results["shape_descriptors"]
    lines += [
        f"Shape: {shape['shape_classification']}",
        f"  - Volume: {shape['volume_cm3']:.2f} cm³",
        f"  - Surface area: {shape['surface_area_mm2']:.0f} mm²",
        f"  - Sphericity: {shape['sphericity']:.2f} ({shape['shape_classification'].lower()})",
        f"  - Elongation: {shape['elongation']:.2f} ({shape['elongation_classification'].lower()})",
        "",
    ]
    border = results["border_regularity"]
    lines += [
        f"Contour Shape: {border['classification']}",
        "  (Measures outer surface smoothness, not intensity transition)",
        f"  {border['description']}",
        "",
    ]
    margin = results["margin_definition"]
    lines += [
        f"Margin Transition: {margin['classification']}",
        "  (Measures tumor-brain intensity demarcation)",
        f"  {margin['description']}",
        "",
        f"Morphology Summary: {border['classification']} contour with {margin['classification'].lower()} margins",
        "",
    ]
    necro = results["necrosis_pattern"]
    if necro["necrosis_present"]:
        lines += [
            f"Necrosis: {necro['pattern']}",
            f"  - Volume: {necro['necrosis_volume_cm3']:.2f} cm³ ({necro['necrosis_percentage']:.0f}% of tumor)",
            f"  - Location: {necro['location']}",
            f"  {necro['description']}",
        ]
    else:
        lines += [f"Necrosis: {necro['pattern']}", f"  {necro['description']}"]
    lines.append("")
    cystic = results["cystic_solid_classification"]
    lines += [
        f"Cystic/Solid: {cystic['classification']}",
        f"  - Solid: {cystic['solid_percentage']:.0f}%, Cystic: {cystic['cystic_percentage']:.0f}%",
        f"  {cystic['description']}",
    ]
    if "signal_characteristics" in cystic:
        lines += [
            f"  - T2 signal: {cystic['signal_characteristics']['t2_homogeneity']}",
            f"  - FLAIR: {cystic['signal_characteristics']['flair_suppression']}",
        ]
    return "\n".join(lines)


def analyze_morphology(ctx: FeatureContext) -> Dict:
    """Run step 4 on a loaded case; returns the reference-schema dict."""
    results = {
        "case_id": ctx.case_id,
        "step": "Step 4 - Tumor morphology and margins",
        "voxel_info": ctx.voxel_info(),
        "shape_descriptors": calculate_shape_descriptors(ctx),
        "border_regularity": analyze_border_regularity(ctx.tumor_masks["wt"], ctx),
        "margin_definition": analyze_margin_definition(ctx),
        "necrosis_pattern": analyze_necrosis_pattern(ctx),
        "cystic_solid_classification": analyze_cystic_vs_solid(ctx),
    }
    results["text_summary"] = _text_summary(results)
    return results
