"""BraTS case discovery, modality order and case loading.

Copy of ``braintpu/io/brats.py`` restricted to what the segment and
pipeline paths use: case discovery across the BraTS-2021 and BraTS-2025
naming schemes, the in-place BraTS-2025 -> 2021 rename that the pipeline's
first stage runs, the canonical modality -> channel order, and
:func:`load_case_volumes` through the pure-Python NIfTI codec (the port has
no native decoder yet, so the rename gzips with the standard library).
"""

from __future__ import annotations

import gzip
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
    "convert_filename_2025_to_2021",
    "rename_brats2025_folder",
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


def convert_filename_2025_to_2021(filename: str) -> Tuple[Optional[str], bool]:
    """Map a BraTS-2025 filename to 2021 convention.

    Returns ``(new_name, needs_compression)``; ``(None, False)`` when the name
    is not a 2025-scheme file.  Output always uses ``.nii.gz``.
    """
    m = BRATS2025_PATTERN.match(filename)
    if not m:
        return None, False
    new_suffix = SUFFIX_MAP_2025_TO_2021[m.group("suffix")]
    return f"{m.group('case')}_{new_suffix}.nii.gz", m.group("ext") == "nii"


def rename_brats2025_folder(folder: os.PathLike, dry_run: bool = False) -> List[Tuple[str, str]]:
    """Rename (and gzip-compress when needed) all 2025-scheme files in place.

    Returns the list of ``(old_name, new_name)`` pairs that were (or would be)
    converted.  Files already in 2021 convention are left untouched.
    """
    folder = Path(folder)
    changes: List[Tuple[str, str]] = []
    for entry in sorted(folder.iterdir()):
        if not entry.is_file():
            continue
        new_name, needs_gz = convert_filename_2025_to_2021(entry.name)
        if new_name is None:
            continue
        changes.append((entry.name, new_name))
        if dry_run:
            continue
        dst = folder / new_name
        if needs_gz:
            with gzip.open(dst, "wb") as f_out:
                f_out.write(entry.read_bytes())
            entry.unlink()
        else:
            entry.rename(dst)
    return changes


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
