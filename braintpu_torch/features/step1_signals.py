"""Feature step 1: sequence-specific signal findings.

Semantics-parity re-implementation of
upstream feature_extraction/step1_sequence_findings.py:
* five-bin semantic signal labels at ratio thresholds 0.6 / 0.85 / 1.15 / 1.5
  (ref :41-60),
* per-region (NCR/ED/ET) per-sequence intensity stats + ratio-to-normal +
  enhancement ratio (ref :71-132),
* enhancement heterogeneity CV bins 0.15 / 0.25 / 0.35 (ref :208-220),
* ring-vs-solid pattern via 2-iteration NCR dilation overlap > 30 % of ET
  (ref :223-236),
* enhancement strength bins 1.05 / 1.2 / 1.5 / 2.0 (ref :239-250),
* T2/FLAIR mismatch: T2 ratio > 1.3 and FLAIR < 0.7 × T2 ratio (ref :255-284),
* technique section with explicit ``<not provided>`` hallucination guards
  (ref :291-332, 409-459).

Output dict keys match the reference's JSON schema so downstream consumers
(report templates, RAG packaging) are drop-in compatible.
"""

from __future__ import annotations

from typing import Dict, Optional

from .boxops import binary_dilation_bbox
from .context import FeatureContext

__all__ = ["signal_label", "analyze_sequence_findings"]

SEQ_KEYS = {"t1": "T1", "t2": "T2", "flair": "FLAIR", "t1ce": "T1ce"}
REGION_NAMES = {
    "ncr": "Necrotic Core (NCR)",
    "ed": "Peritumoral Edema (ED)",
    "et": "Enhancing Tumor (ET)",
}


def signal_label(ratio: float) -> str:
    """Five-bin semantic intensity label (thresholds 0.6/0.85/1.15/1.5)."""
    if ratio < 0.6:
        return "markedly hypointense"
    if ratio < 0.85:
        return "hypointense"
    if ratio < 1.15:
        return "isointense"
    if ratio < 1.5:
        return "hyperintense"
    return "markedly hyperintense"


def _region_signals(ctx: FeatureContext, region_key: str) -> Optional[Dict]:
    mask = ctx.tumor_masks[region_key]
    if mask.sum() == 0:
        return None
    out: Dict = {
        "region": REGION_NAMES[region_key],
        "voxel_count": int(mask.sum()),
    }
    labels = {}
    region_means = {}
    for mod, key in SEQ_KEYS.items():
        stats = ctx.region_stats(region_key, mod)
        normal_mean = ctx.normal_stats(mod)["mean"]
        ratio = (
            stats["mean"] / normal_mean if normal_mean and normal_mean > 0 else 1.0
        )
        labels[key] = signal_label(ratio)
        region_means[key] = stats["mean"]
        out[key] = {
            "mean_intensity": float(stats["mean"]),
            "std": float(stats["std"]),
            "ratio_to_normal": round(float(ratio), 3),
            "signal_label": labels[key],
        }
    t1_mean = region_means["T1"]
    out["T1ce"]["enhancement_ratio"] = round(
        float(region_means["T1ce"] / t1_mean if t1_mean and t1_mean > 0 else 1.0), 3
    )
    out["signal_summary"] = ", ".join(
        [f"T1 {labels['T1']}", f"T2 {labels['T2']}", f"FLAIR {labels['FLAIR']}", f"T1ce {labels['T1ce']}"]
    )
    return out


def _all_region_signals(ctx: FeatureContext) -> Dict:
    ref = {
        "methodology": "Combined gray matter + white matter (non-tumor, non-CSF brain tissue)",
        "T1_mean": ctx.normal_stats("t1")["mean"],
        "T2_mean": ctx.normal_stats("t2")["mean"],
        "FLAIR_mean": ctx.normal_stats("flair")["mean"],
        "T1ce_mean": ctx.normal_stats("t1ce")["mean"],
        "voxel_count": ctx.normal_stats("t1")["voxel_count"],
    }
    regions = {}
    for key in ("ncr", "ed", "et"):
        r = _region_signals(ctx, key)
        if r is not None:
            regions[key] = r
    return {"normal_brain_reference": ref, "regions": regions}


def _contrast_enhancement(ctx: FeatureContext, region_signals: Dict) -> Dict:
    masks = ctx.tumor_masks
    et, ncr = masks["et"], masks["ncr"]
    results: Dict = {
        "enhancement_present": bool(et.sum() > 0),
        "pattern": None,
        "heterogeneity": None,
        "metrics": {},
    }
    if not results["enhancement_present"]:
        results["pattern"] = "Non-enhancing"
        results["heterogeneity"] = "Not applicable"
        results["description"] = (
            "Non-enhancing pattern can be seen with lower-grade glioma, treatment "
            "effect, or other pathology; clinical and histopathological correlation required"
        )
        return results

    et_sig = region_signals["regions"].get("et")
    if et_sig:
        results["metrics"]["enhancement_ratio_T1ce_over_T1"] = et_sig["T1ce"]["enhancement_ratio"]
        results["metrics"]["T1ce_ratio_to_normal"] = et_sig["T1ce"]["ratio_to_normal"]
        mean, std = et_sig["T1ce"]["mean_intensity"], et_sig["T1ce"]["std"]
        if mean > 0:
            cv = std / mean
            results["metrics"]["coefficient_of_variation"] = round(float(cv), 3)
            if cv > 0.35:
                results["heterogeneity"] = "Markedly heterogeneous"
            elif cv > 0.25:
                results["heterogeneity"] = "Heterogeneous"
            elif cv > 0.15:
                results["heterogeneity"] = "Mildly heterogeneous"
            else:
                results["heterogeneity"] = "Homogeneous"

    if ncr.sum() > 0:
        ring_overlap = int((binary_dilation_bbox(ncr, iterations=2) & et).sum())
        if ring_overlap > 0.3 * et.sum():
            results["pattern"] = "Ring-enhancing"
            results["description"] = (
                "Peripheral rim enhancement surrounding central non-enhancing core, "
                "characteristic of high-grade glioma or metastasis"
            )
        else:
            results["pattern"] = "Solid/nodular enhancing"
            results["description"] = "Solid pattern of enhancement without central necrosis"
    else:
        results["pattern"] = "Solid/nodular enhancing"
        results["description"] = "Solid pattern of enhancement without central necrosis"

    ratio = results["metrics"].get("enhancement_ratio_T1ce_over_T1")
    if ratio is not None:
        if ratio > 2.0:
            results["enhancement_strength"] = "Marked enhancement"
        elif ratio > 1.5:
            results["enhancement_strength"] = "Strong enhancement"
        elif ratio > 1.2:
            results["enhancement_strength"] = "Moderate enhancement"
        elif ratio > 1.05:
            results["enhancement_strength"] = "Mild enhancement"
        else:
            results["enhancement_strength"] = "Minimal/equivocal enhancement"
    return results


def _t2_flair_mismatch(region_signals: Dict) -> Dict:
    results: Dict = {"mismatch_detected": False, "description": None}
    for key, region in region_signals["regions"].items():
        t2 = region["T2"]["ratio_to_normal"]
        flair = region["FLAIR"]["ratio_to_normal"]
        if t2 > 1.3 and flair < t2 * 0.7:
            results.update(
                mismatch_detected=True,
                region=key,
                t2_ratio=t2,
                flair_ratio=flair,
                description=(
                    f"Possible T2/FLAIR mismatch in {region['region']}: T2 hyperintense "
                    f"(ratio {t2:.2f}) with relatively suppressed FLAIR (ratio {flair:.2f}). "
                    "May suggest IDH-mutant lower-grade glioma."
                ),
            )
            return results
    results["description"] = (
        "No T2/FLAIR mismatch detected. Signal intensity patterns concordant "
        "between T2 and FLAIR sequences."
    )
    return results


def _technique_section(ctx: FeatureContext) -> Dict:
    acq = ctx.acquisition_details()
    performed = []
    detail: Dict = {}
    for mod, key in (("t1", "T1"), ("t1ce", "T1CE"), ("t2", "T2"), ("flair", "FLAIR")):
        present = mod in ctx.modalities
        if present:
            performed.append(key)
            detail[key] = {
                "available": True,
                "file": ctx.modality_files.get(mod),
                "slice_thickness_mm": acq["slice_thickness_mm"],
                "in_plane_resolution_mm": acq["in_plane_resolution_mm"],
                "matrix_size": acq["matrix_size"],
                "num_slices": acq["num_slices"],
            }
        else:
            detail[key] = {"available": False, "file": None}
    detail["DWI"] = {"available": False, "note": "Not included in BraTS dataset"}
    detail["ADC"] = {"available": False, "note": "Not included in BraTS dataset"}
    contrast = "t1ce" in ctx.modalities
    return {
        "sequences_performed": performed,
        "sequences_detail": detail,
        "contrast_administered": contrast,
        "contrast_note": (
            "Gadolinium-based contrast agent (inferred from T1ce sequence presence)"
            if contrast
            else "No post-contrast imaging available"
        ),
        "acquisition_parameters": {
            "slice_thickness_mm": acq["slice_thickness_mm"],
            "in_plane_resolution_mm": acq["in_plane_resolution_mm"],
            "voxel_size_mm": acq["voxel_size_mm"],
            "matrix_size": acq["matrix_size"],
            "num_slices": acq["num_slices"],
        },
        "sequences_not_available": ["DWI", "ADC", "MRS", "Perfusion"],
        "note": "Acquisition parameters extracted from NIfTI headers; original scanner parameters may differ",
    }


def _text_summary(results: Dict) -> str:
    lines = [
        "CLINICAL INFORMATION:",
        "  Patient age: <not provided>",
        "  Patient sex: <not provided>",
        "  Clinical history: <not provided>",
        "  Presenting symptoms: <not provided>",
        "  [Note: Do not fabricate - include only if provided in clinical records]",
        "",
        "TECHNIQUE:",
    ]
    tech = results["technique"]
    seqs = tech.get("sequences_performed", [])
    lines.append(
        f"  Sequences performed: {', '.join(seqs)}" if seqs else "  Sequences performed: <not provided>"
    )
    if tech.get("contrast_administered"):
        lines.append(f"  Contrast: Administered ({tech.get('contrast_note', 'Gadolinium-based')})")
    else:
        lines.append("  Contrast: Not administered or not available")
    acq = tech.get("acquisition_parameters", {})
    if acq:
        ip = acq["in_plane_resolution_mm"]
        mx = acq["matrix_size"]
        lines.append(f"  Slice thickness: {acq['slice_thickness_mm']} mm")
        lines.append(f"  In-plane resolution: {ip[0]:.2f} × {ip[1]:.2f} mm")
        lines.append(f"  Matrix size: {mx[0]} × {mx[1]} × {mx[2]}")
    na = tech.get("sequences_not_available", [])
    if na:
        lines.append(f"  Not available: {', '.join(na)}")
    lines += [
        "",
        "SEQUENCE-SPECIFIC FINDINGS:",
        "",
        "Reference: Normal brain tissue (combined GM+WM, excluding tumor and CSF)",
        "",
        "Signal Characteristics by Region:",
    ]
    for key in ("ncr", "ed", "et"):
        region = results["region_signal_analysis"]["regions"].get(key)
        if region:
            lines.append(f"  {region['region']}:")
            lines.append(f"    {region['signal_summary']}")
            lines.append(
                "    Ratios - T1: {:.2f}, T2: {:.2f}, FLAIR: {:.2f}, T1ce: {:.2f}".format(
                    region["T1"]["ratio_to_normal"],
                    region["T2"]["ratio_to_normal"],
                    region["FLAIR"]["ratio_to_normal"],
                    region["T1ce"]["ratio_to_normal"],
                )
            )
    enh = results["contrast_enhancement"]
    lines += ["", f"Contrast Enhancement: {enh['pattern']}"]
    if "enhancement_strength" in enh:
        lines.append(f"  Strength: {enh['enhancement_strength']}")
    if enh.get("heterogeneity"):
        lines.append(f"  Heterogeneity: {enh['heterogeneity']}")
    if "description" in enh:
        lines.append(f"  {enh['description']}")
    mism = results["t2_flair_mismatch"]
    lines += [
        "",
        f"T2/FLAIR Mismatch: {'Present' if mism['mismatch_detected'] else 'Not detected'}",
        f"  {mism['description']}",
        "",
        "Tumor Volumes:",
    ]
    for region, vol in results["volumes"].items():
        if vol > 0:
            lines.append(f"  - {region}: {vol:.2f} cm³")
    lines += ["", "Note: Diffusion-weighted imaging (DWI/ADC) not available in standard BraTS dataset"]
    return "\n".join(lines)


def analyze_sequence_findings(ctx: FeatureContext) -> Dict:
    """Run step 1 on a loaded case; returns the reference-schema dict."""
    region_signals = _all_region_signals(ctx)
    enhancement = _contrast_enhancement(ctx, region_signals)
    mismatch = _t2_flair_mismatch(region_signals)
    volumes = {
        "Whole Tumor (WT)": ctx.region_volume_cm3("wt"),
        "Tumor Core (TC)": ctx.region_volume_cm3("tc"),
        "Enhancing Tumor (ET)": ctx.region_volume_cm3("et"),
        "Necrotic Core (NCR)": ctx.region_volume_cm3("ncr"),
        "Peritumoral Edema (ED)": ctx.region_volume_cm3("ed"),
    }
    results = {
        "case_id": ctx.case_id,
        "step": "Step 1 - Sequence-specific findings",
        "technique": _technique_section(ctx),
        "voxel_info": ctx.voxel_info(),
        "region_signal_analysis": region_signals,
        "contrast_enhancement": enhancement,
        "t2_flair_mismatch": mismatch,
        "volumes": volumes,
        "sequences_analyzed": ["T1", "T1ce", "T2", "FLAIR"],
        "diffusion_available": False,
        "diffusion_note": "DWI/ADC not available in standard BraTS dataset",
    }
    results["text_summary"] = _text_summary(results)
    return results
