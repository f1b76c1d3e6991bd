"""BraTS case discovery, modality order and case loading.

Copy of ``braintpu/io/brats.py`` restricted to what the segment path uses:
case discovery across the BraTS-2021 and BraTS-2025 naming schemes, the
canonical modality -> channel order, and :func:`load_case_volumes` through
the pure-Python NIfTI codec (the port has no native decoder yet).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import nifti

__all__ = [
    "MODALITIES",
    "MODALITY_CHANNEL",
    "SUFFIX_MAP_2025_TO_2021",
    "BRATS2025_PATTERN",
    "BratsCase",
    "find_cases",
    "load_case_volumes",
]

#: Canonical modality order = nnU-Net channel order (T1→0000 … FLAIR→0003).
MODALITIES: Tuple[str, ...] = ("t1", "t1ce", "t2", "flair")
MODALITY_CHANNEL: Dict[str, int] = {m: i for i, m in enumerate(MODALITIES)}

#: BraTS-2025 suffixes → BraTS-2021 suffixes.
SUFFIX_MAP_2025_TO_2021: Dict[str, str] = {
    "t1n": "t1",
    "t1c": "t1ce",
    "t2w": "t2",
    "t2f": "flair",
    "seg": "seg",
}

BRATS2025_PATTERN = re.compile(
    r"^(?P<case>BraTS-[A-Za-z]+-\d{5}-\d{3})-(?P<suffix>t1n|t1c|t2w|t2f|seg)"
    r"\.(?P<ext>nii(?:\.gz)?)$"
)

_2021_SUFFIX = r"(?P<suffix>t1ce|t1|t2|flair|seg)"
BRATS2021_PATTERN = re.compile(
    rf"^(?P<case>.+)_{_2021_SUFFIX}\.(?P<ext>nii(?:\.gz)?)$"
)


@dataclass
class BratsCase:
    """A resolved BraTS case: one path per modality (+ optional ground truth)."""

    case_id: str
    modality_paths: Dict[str, Path]  # keys: t1, t1ce, t2, flair
    seg_path: Optional[Path] = None
    folder: Optional[Path] = None

    @property
    def is_complete(self) -> bool:
        return all(m in self.modality_paths for m in MODALITIES)

    def ordered_paths(self) -> List[Path]:
        """Paths in canonical channel order (T1, T1ce, T2, FLAIR)."""
        return [self.modality_paths[m] for m in MODALITIES]


def _scan_folder(folder: Path) -> Dict[str, BratsCase]:
    cases: Dict[str, BratsCase] = {}
    for entry in sorted(folder.iterdir()):
        if not entry.is_file() or ".nii" not in entry.name:
            continue
        suffix = None
        case_id = None
        m25 = BRATS2025_PATTERN.match(entry.name)
        if m25:
            case_id = m25.group("case")
            suffix = SUFFIX_MAP_2025_TO_2021[m25.group("suffix")]
        else:
            m21 = BRATS2021_PATTERN.match(entry.name)
            if m21:
                case_id = m21.group("case")
                suffix = m21.group("suffix")
        if case_id is None:
            continue
        case = cases.setdefault(case_id, BratsCase(case_id, {}, folder=folder))
        if suffix == "seg":
            case.seg_path = entry
        else:
            case.modality_paths[suffix] = entry
    return cases


def find_cases(root: os.PathLike, recursive: bool = True) -> List[BratsCase]:
    """Discover BraTS cases under ``root`` (both 2021 and 2025 naming).

    A case is returned only if all four modalities are present; cases keep the
    ground-truth `seg` path when one exists alongside.
    """
    root = Path(root)
    folders = [root]
    if recursive:
        folders += [p for p in sorted(root.rglob("*")) if p.is_dir()]
    out: List[BratsCase] = []
    seen = set()
    for folder in folders:
        for case_id, case in _scan_folder(folder).items():
            key = (case_id, str(folder))
            if case.is_complete and key not in seen:
                seen.add(key)
                out.append(case)
    return out


def load_case_volumes(case: BratsCase) -> Tuple[np.ndarray, np.ndarray, Tuple[float, ...]]:
    """Load the four modalities as a float32 (4, X, Y, Z) stack.

    Returns ``(data, affine, zooms)``.  All modalities must share a shape;
    the affine/zooms of the first modality are used (BraTS volumes are
    co-registered on a 1 mm isotropic grid).
    """
    imgs = [nifti.load(p) for p in case.ordered_paths()]
    shapes = {im.shape for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f"modality shape mismatch for {case.case_id}: {shapes}")
    data = np.stack([im.get_fdata(dtype=np.float32) for im in imgs], axis=0)
    return data, imgs[0].affine, imgs[0].get_zooms()
