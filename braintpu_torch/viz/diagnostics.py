"""Label diagnostics: unique-label audit + BraTS-compliance analysis.

Structured-data re-design of upstream check_labels.py:12-122 — instead
of printing, :func:`audit_labels` returns a dict (per-label counts/volumes,
convention detection, compliance verdicts, actionable hints);
:func:`format_label_audit` renders the human report.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..io import nifti

__all__ = ["audit_labels", "format_label_audit"]

LABEL_NAMES = {
    0: "Background",
    1: "NCR (Necrotic Tumor Core)",
    2: "ED (Peritumoral Edema)",
    3: "ET (Enhancing Tumor) - BraTS2025",
    4: "ET (Enhancing Tumor) - BraTS2021",
}


def audit_labels(seg: np.ndarray, zooms=(1.0, 1.0, 1.0)) -> Dict:
    """Audit a segmentation's label content; returns a structured report."""
    seg = np.round(np.asarray(seg)).astype(np.int64)
    labels, counts = np.unique(seg, return_counts=True)
    voxel_mm3 = float(np.prod(zooms[:3]))
    total = seg.size

    per_label = {
        int(l): {
            "name": LABEL_NAMES.get(int(l), f"Unknown (Label {int(l)})"),
            "count": int(c),
            "percentage": float(c / total * 100),
            "volume_cm3": float(c * voxel_mm3 / 1000),
        }
        for l, c in zip(labels, counts)
    }

    present = set(int(l) for l in labels)
    tumor_labels = present & {1, 2, 3, 4}
    if 4 in present and 3 not in present:
        convention = "brats2021"
    elif 3 in present and 4 not in present:
        convention = "brats2025"
    elif not tumor_labels:
        convention = "empty"
    elif {3, 4} <= present:
        convention = "mixed"
    else:
        convention = "partial"

    hints = []
    if convention == "empty":
        hints.append("No tumor labels present - inference may have failed")
    if convention == "mixed":
        hints.append("Both ET=3 and ET=4 present - label space is inconsistent")
    if convention == "partial":
        missing = sorted({1, 2} - present)
        if missing:
            hints.append(f"Missing tumor labels: {missing}")
        if not ({3, 4} & present):
            hints.append(
                "No enhancing-tumor label (3 or 4): check regions export or "
                "whether the lesion is genuinely non-enhancing"
            )
    unknown = sorted(present - {0, 1, 2, 3, 4})
    if unknown:
        hints.append(f"Unexpected label values: {unknown}")

    tumor_count = int(sum(per_label[l]["count"] for l in tumor_labels))
    return {
        "shape": list(seg.shape),
        "labels": per_label,
        "convention": convention,
        "tumor_voxels": tumor_count,
        "tumor_volume_cm3": float(tumor_count * voxel_mm3 / 1000),
        "is_brats_compliant": convention in ("brats2021", "brats2025"),
        "hints": hints,
    }


def audit_labels_file(path) -> Dict:
    img = nifti.load(path)
    report = audit_labels(img.get_fdata(dtype=np.float32), img.get_zooms())
    report["file"] = str(path)
    return report


def format_label_audit(report: Dict) -> str:
    lines = [f"Label audit — shape {tuple(report['shape'])}"]
    for label, info in sorted(report["labels"].items()):
        lines.append(
            f"  label {label:2d}  {info['name']:<38} "
            f"{info['count']:>12,}  ({info['percentage']:6.2f} %)  "
            f"{info['volume_cm3']:8.2f} cm³"
        )
    lines.append(f"convention: {report['convention']}"
                 f" ({'BraTS compliant' if report['is_brats_compliant'] else 'NOT compliant'})")
    lines.append(f"tumor volume: {report['tumor_volume_cm3']:.2f} cm³")
    for hint in report["hints"]:
        lines.append(f"  ! {hint}")
    return "\n".join(lines)
