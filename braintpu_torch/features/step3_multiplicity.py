"""Feature step 3: lesion multiplicity & spatial distribution.

Semantics-parity re-implementation of
upstream feature_extraction/step3_multiplicity.py:
* 26-connected 3D components (ref :57-59) with a 0.1 cm³ minimum-lesion
  filter (ref :38, :123-125), volume-ranked with primary/secondary
  classification (ref :127-136),
* per-component centroid/bbox/max-diameter/composition; composition counts
  ``et`` as ``seg==3`` only — the reference's documented quirk vs
  ``utils.get_tumor_masks`` (SURVEY.md §7; ref :105-109, :212),
* pairwise centroid distances with satellite (<20 mm) / separate (>40 mm)
  thresholds (ref :34-35, :155-204),
* ET-foci analysis on ``seg==3`` (ref :207-263),
* satellite detection around the primary (ref :266-311),
* distribution-pattern classifier + differential-diagnosis lists
  (ref :314-374).

One host-side ``scipy.ndimage.label`` pass + vectorized per-component stats
via ``ndimage.sum/center_of_mass``-free bincount math (no per-component
full-volume rescans).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy import ndimage

from .context import FeatureContext

__all__ = [
    "SATELLITE_DISTANCE_MM",
    "SEPARATE_DISTANCE_MM",
    "MIN_LESION_VOLUME_CM3",
    "analyze_multiplicity",
]

SATELLITE_DISTANCE_MM = 20
SEPARATE_DISTANCE_MM = 40
MIN_LESION_VOLUME_CM3 = 0.1

_STRUCT26 = ndimage.generate_binary_structure(3, 3)


def _component_stats(seg: np.ndarray, mask: np.ndarray, voxel_dims) -> List[Dict]:
    """Per-component properties from one labeling pass, fully vectorized.

    A degraded segmentation (e.g. random weights, or a corrupt upload) can
    contain tens of thousands of speckle components; the previous
    per-component ``ids == comp_id`` rescan was O(n_components × n_voxels)
    and measured 84.8 s on a random-weights serve job.  Every aggregate
    below (centroid sums, bbox min/max, per-label composition) now comes
    from grouped one-pass reductions — a sort-free ``np.bincount`` /
    ``minimum.at`` pass each — so the same case costs tens of ms.
    """
    labeled, n = ndimage.label(mask, structure=_STRUCT26)
    if n == 0:
        return []
    vox_mm3 = float(np.prod(voxel_dims))
    coords = np.nonzero(labeled)
    ids = labeled[coords]
    sizes = np.bincount(ids, minlength=n + 1)

    # centroid sums per component (one bincount per axis)
    csum = [np.bincount(ids, weights=coords[a], minlength=n + 1) for a in range(3)]
    # bbox extrema per component
    bmin = [np.full(n + 1, np.iinfo(np.int64).max, np.int64) for _ in range(3)]
    bmax = [np.full(n + 1, -1, np.int64) for _ in range(3)]
    for a in range(3):
        np.minimum.at(bmin[a], ids, coords[a])
        np.maximum.at(bmax[a], ids, coords[a])
    # composition: one bincount over (component, label) pair indices —
    # labels of interest are 1/2/3 (reference quirk: et = seg==3 only)
    seg_raw = seg[coords]
    # out-of-range labels (4+, negatives) count toward NO composition bucket,
    # exactly like the original ==1/==2/==3 comparisons
    seg_at = np.where((seg_raw >= 1) & (seg_raw <= 3), seg_raw, 0).astype(np.int64)
    pair = np.bincount(ids * 4 + seg_at, minlength=(n + 1) * 4).reshape(n + 1, 4)

    comps = []
    for comp_id in range(1, n + 1):
        size = int(sizes[comp_id])
        centroid = {
            k: float(csum[a][comp_id] / size) for a, k in enumerate("xyz")
        }
        centroid_mm = {
            k: centroid[k] * voxel_dims[a] for a, k in enumerate("xyz")
        }
        bbox = {}
        for a, k in enumerate("xyz"):
            bbox[f"{k}_min"] = int(bmin[a][comp_id])
            bbox[f"{k}_max"] = int(bmax[a][comp_id])
        max_diameter = max(
            (bbox["x_max"] - bbox["x_min"]) * voxel_dims[0],
            (bbox["y_max"] - bbox["y_min"]) * voxel_dims[1],
            (bbox["z_max"] - bbox["z_min"]) * voxel_dims[2],
        )
        composition = {
            "ncr": int(pair[comp_id, 1]),
            "ed": int(pair[comp_id, 2]),
            "et": int(pair[comp_id, 3]),
        }
        comps.append(
            {
                "id": comp_id,
                "voxel_count": size,
                "volume_cm3": float(size * vox_mm3 / 1000),
                "centroid_voxel": centroid,
                "centroid_mm": centroid_mm,
                "bounding_box": bbox,
                "max_diameter_mm": float(max_diameter),
                "composition": composition,
                "has_enhancement": composition["et"] > 0,
            }
        )
    return comps


def detect_connected_components(ctx: FeatureContext) -> Dict:
    tumor = ctx.tumor_masks["wt"]
    if tumor.sum() == 0:
        return {
            "num_components": 0,
            "components": [],
            "is_single_lesion": True,
            "description": "No tumor detected",
        }
    comps = _component_stats(ctx.seg, tumor, ctx.zooms)
    significant = [c for c in comps if c["volume_cm3"] >= MIN_LESION_VOLUME_CM3]
    noise = len(comps) - len(significant)
    significant.sort(key=lambda c: c["volume_cm3"], reverse=True)
    for i, c in enumerate(significant):
        c["rank"] = i + 1
        c["classification"] = "Primary lesion" if i == 0 else f"Secondary lesion #{i}"
    note = (
        f" ({noise} sub-threshold fragments excluded, <{MIN_LESION_VOLUME_CM3} cm³)"
        if noise
        else ""
    )
    return {
        "num_components": len(significant),
        "components": significant,
        "is_single_lesion": len(significant) == 1,
        "description": f"{len(significant)} lesion(s) detected{note}",
        "excluded_fragments": noise,
        "minimum_volume_threshold_cm3": MIN_LESION_VOLUME_CM3,
    }


def classify_distance_relationship(distance_mm: float) -> str:
    if distance_mm < SATELLITE_DISTANCE_MM:
        return "Satellite/adjacent"
    if distance_mm < SEPARATE_DISTANCE_MM:
        return "Regional spread"
    return "Distant/separate"


def calculate_inter_lesion_distances(components: List[Dict]) -> Dict:
    if len(components) < 2:
        return {
            "distances": [],
            "min_distance_mm": None,
            "max_distance_mm": None,
            "mean_distance_mm": None,
        }
    pts = np.array(
        [[c["centroid_mm"]["x"], c["centroid_mm"]["y"], c["centroid_mm"]["z"]] for c in components]
    )
    distances = []
    for i in range(len(components)):
        for j in range(i + 1, len(components)):
            d = float(np.linalg.norm(pts[i] - pts[j]))
            distances.append(
                {
                    "component_1": components[i]["id"],
                    "component_2": components[j]["id"],
                    "distance_mm": d,
                    "relationship": classify_distance_relationship(d),
                }
            )
    vals = [d["distance_mm"] for d in distances]
    return {
        "distances": distances,
        "min_distance_mm": float(min(vals)),
        "max_distance_mm": float(max(vals)),
        "mean_distance_mm": float(np.mean(vals)),
    }


def analyze_enhancing_components(ctx: FeatureContext) -> Dict:
    # NOTE: deliberately seg==3 only (reference quirk; ET=4 inputs should be
    # remapped to 2025 space before feature extraction).
    et = ctx.seg == 3
    if et.sum() == 0:
        return {
            "num_enhancing_foci": 0,
            "enhancing_components": [],
            "pattern": "Non-enhancing",
            "description": "No enhancing tumor components detected",
        }
    comps = _component_stats(ctx.seg, et, ctx.zooms)
    et_comps = [
        {"id": c["id"], "volume_cm3": c["volume_cm3"], "centroid_mm": c["centroid_mm"]}
        for c in comps
    ]
    et_comps.sort(key=lambda c: c["volume_cm3"], reverse=True)
    n = len(et_comps)
    if n == 1:
        pattern = "Single enhancing focus"
    elif n <= 3:
        pattern = "Few enhancing foci"
    else:
        pattern = "Multiple/scattered enhancing foci"
    return {
        "num_enhancing_foci": n,
        "enhancing_components": et_comps,
        "pattern": pattern,
        "total_enhancing_volume_cm3": float(sum(c["volume_cm3"] for c in et_comps)),
        "description": f"{n} separate enhancing focus/foci detected",
    }


def detect_satellite_lesions(components: List[Dict]) -> Dict:
    if len(components) < 2:
        return {
            "satellite_count": 0,
            "satellites": [],
            "has_satellites": False,
            "description": "Single lesion, no satellites",
        }
    p = components[0]["centroid_mm"]
    satellites = []
    for comp in components[1:]:
        c = comp["centroid_mm"]
        d = float(
            np.sqrt((p["x"] - c["x"]) ** 2 + (p["y"] - c["y"]) ** 2 + (p["z"] - c["z"]) ** 2)
        )
        if d < SATELLITE_DISTANCE_MM:
            satellites.append(
                {
                    "component_id": comp["id"],
                    "volume_cm3": comp["volume_cm3"],
                    "distance_from_primary_mm": d,
                    "has_enhancement": comp["has_enhancement"],
                }
            )
    description = (
        f"{len(satellites)} satellite lesion(s) within {SATELLITE_DISTANCE_MM}mm of primary tumor"
        if satellites
        else "No satellite lesions detected"
    )
    return {
        "satellite_count": len(satellites),
        "satellites": satellites,
        "has_satellites": bool(satellites),
        "satellite_threshold_mm": SATELLITE_DISTANCE_MM,
        "description": description,
    }


def classify_distribution_pattern(
    component_analysis: Dict, distance_analysis: Dict, satellite_analysis: Dict, enhancing_analysis: Dict
) -> Dict:
    n = component_analysis["num_components"]
    if n == 0:
        return {
            "pattern": "No tumor",
            "classification": "No lesion detected",
            "clinical_implication": "N/A",
            "differential_considerations": [],
        }
    if n == 1:
        pattern = "Solitary"
        classification = "Single contiguous lesion"
        implication = "Unifocal disease, typical for primary brain tumor"
        differentials = ["Primary glioma", "Solitary metastasis", "Lymphoma", "Abscess"]
    elif satellite_analysis["has_satellites"]:
        pattern = "Primary with satellites"
        classification = "Main lesion with satellite nodules"
        implication = "Suggests local tumor spread or infiltrative growth pattern"
        differentials = [
            "High-grade glioma with infiltration",
            "Multicentric glioma",
            "Inflammatory process",
        ]
    elif n <= 3:
        max_d = distance_analysis["max_distance_mm"]
        if max_d and max_d < SEPARATE_DISTANCE_MM:
            pattern = "Regional multifocal"
            classification = "Few lesions in regional distribution"
            implication = "Regional disease, may be contiguous or multicentric"
            differentials = ["Multicentric glioma", "Regional metastases", "Demyelinating disease"]
        else:
            pattern = "Distant multifocal"
            classification = "Separate lesions in different brain regions"
            implication = "Multifocal disease, consider metastatic process"
            differentials = [
                "Metastatic disease",
                "Multicentric glioma",
                "CNS lymphoma",
                "Multifocal infection",
            ]
    else:
        pattern = "Diffuse/scattered"
        classification = "Multiple lesions throughout brain"
        implication = "Diffuse disease pattern, high probability of metastatic or systemic process"
        differentials = [
            "Metastatic carcinoma",
            "CNS lymphoma",
            "Miliary tuberculosis",
            "Septic emboli",
        ]

    n_enh = enhancing_analysis["num_enhancing_foci"]
    if n_enh == 0:
        enhancement_note = "Non-enhancing pattern may suggest low-grade pathology"
    elif n_enh > n:
        enhancement_note = "Multiple enhancing foci within lesions suggest heterogeneous enhancement"
    else:
        enhancement_note = "Enhancement pattern consistent with lesion count"

    return {
        "pattern": pattern,
        "classification": classification,
        "clinical_implication": implication,
        "differential_considerations": differentials,
        "enhancement_note": enhancement_note,
        "lesion_count": n,
        "enhancing_foci_count": n_enh,
    }


def _text_summary(results: Dict) -> str:
    lines = ["LESION MULTIPLICITY AND DISTRIBUTION:", ""]
    comp = results["component_analysis"]
    lines.append(f"Lesion Count: {comp['num_components']}")
    if comp["num_components"] == 0:
        lines.append("  No tumor lesions detected")
        return "\n".join(lines)
    primary = comp["components"][0]
    lines.append(
        f"  Primary lesion: {primary['volume_cm3']:.2f} cm³, max diameter {primary['max_diameter_mm']:.1f} mm"
    )
    lines.append(
        "    - Contains enhancing component" if primary["has_enhancement"] else "    - Non-enhancing"
    )
    if comp["num_components"] > 1:
        lines.append(f"  Secondary lesions: {comp['num_components'] - 1}")
        for lesion in comp["components"][1:]:
            lines.append(f"    - Lesion #{lesion['rank']}: {lesion['volume_cm3']:.2f} cm³")
    if results["distance_analysis"]["distances"]:
        dist = results["distance_analysis"]
        lines += [
            "",
            "Inter-lesion Distances:",
            f"  - Minimum: {dist['min_distance_mm']:.1f} mm",
            f"  - Maximum: {dist['max_distance_mm']:.1f} mm",
        ]
    sat = results["satellite_analysis"]
    if sat["has_satellites"]:
        lines += ["", f"Satellite Lesions: {sat['satellite_count']}"]
        for s in sat["satellites"]:
            lines.append(
                f"  - {s['distance_from_primary_mm']:.1f} mm from primary, {s['volume_cm3']:.2f} cm³"
            )
    enh = results["enhancing_analysis"]
    lines += ["", f"Enhancing Foci: {enh['pattern']}"]
    if enh["num_enhancing_foci"] > 0:
        lines.append(f"  - Total enhancing volume: {enh['total_enhancing_volume_cm3']:.2f} cm³")
    dp = results["distribution_pattern"]
    lines += [
        "",
        f"Distribution Pattern: {dp['pattern']}",
        f"  {dp['classification']}",
        f"  Clinical implication: {dp['clinical_implication']}",
    ]
    if dp["differential_considerations"]:
        lines.append("  Differential considerations:")
        for diff in dp["differential_considerations"]:
            lines.append(f"    - {diff}")
    return "\n".join(lines)


def analyze_multiplicity(ctx: FeatureContext) -> Dict:
    """Run step 3 on a loaded case; returns the reference-schema dict."""
    component_analysis = detect_connected_components(ctx)
    distance_analysis = calculate_inter_lesion_distances(component_analysis["components"])
    if component_analysis["components"]:
        satellite_analysis = detect_satellite_lesions(component_analysis["components"])
    else:
        satellite_analysis = {
            "satellite_count": 0,
            "satellites": [],
            "has_satellites": False,
            "description": "No tumor detected",
        }
    enhancing_analysis = analyze_enhancing_components(ctx)
    distribution_pattern = classify_distribution_pattern(
        component_analysis, distance_analysis, satellite_analysis, enhancing_analysis
    )
    results = {
        "case_id": ctx.case_id,
        "step": "Step 3 - Lesion multiplicity and distribution",
        "voxel_info": ctx.voxel_info(),
        "component_analysis": component_analysis,
        "distance_analysis": distance_analysis,
        "satellite_analysis": satellite_analysis,
        "enhancing_analysis": enhancing_analysis,
        "distribution_pattern": distribution_pattern,
    }
    results["text_summary"] = _text_summary(results)
    return results
