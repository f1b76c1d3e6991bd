"""BraTS case discovery, modality order and case loading.

Copy of ``braintpu/io/brats.py``: case discovery across the BraTS-2021 and
BraTS-2025 naming schemes, the in-place BraTS-2025 -> 2021 rename that the
pipeline's first stage runs (gzip through the native parallel writer, else
the standard library), the canonical modality -> channel order,
:func:`load_case_volumes` (the native batch decoder, one zlib thread per
file, else the pure-Python codec; the result names the route it took) and
:class:`CasePrefetcher`, which decodes the next case while the device
segments this one.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import gzip
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
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
    "CaseVolumes",
    "load_case_volumes",
    "load_case_volumes_native",
    "load_case_volumes_python",
    "CasePrefetcher",
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
            payload = entry.read_bytes()
            try:
                # parallel multi-member gzip: ~35 MB per bare .nii volume
                native.write_gz(dst, payload)
            except IOError:
                with gzip.open(dst, "wb") as f_out:
                    f_out.write(payload)
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


class CaseVolumes(tuple):
    """``(data, affine, zooms)`` of one case, as :func:`load_case_volumes`
    returns it (it unpacks as that triple), with ``route``: the decoder that
    read it, ``"native"`` or ``"python"``."""

    route: str

    def __new__(cls, data: np.ndarray, affine: np.ndarray, zooms: Tuple[float, ...],
                route: str) -> "CaseVolumes":
        self = super().__new__(cls, (data, affine, zooms))
        self.route = route
        return self


def _check_shapes(case: BratsCase, shapes) -> None:
    if len(set(shapes)) != 1:
        raise ValueError(f"modality shape mismatch for {case.case_id}: {set(shapes)}")


def load_case_volumes_native(case: BratsCase) -> CaseVolumes:
    """:func:`load_case_volumes` through the native batch decoder (one zlib
    inflate thread per file).  Raises ``IOError`` when the library is
    unavailable or a file does not decode, ``ValueError`` on a shape
    mismatch."""
    paths = case.ordered_paths()
    vols = native.read_batch_f32(paths)
    _check_shapes(case, [v.shape for v in vols])
    _, affine, zooms = nifti.load_header(paths[0])
    return CaseVolumes(np.stack(vols, axis=0), affine, zooms, "native")


def load_case_volumes_python(case: BratsCase) -> CaseVolumes:
    """:func:`load_case_volumes` through the pure-Python codec."""
    imgs = [nifti.load(p) for p in case.ordered_paths()]
    _check_shapes(case, [im.shape for im in imgs])
    data = np.stack([im.get_fdata(dtype=np.float32) for im in imgs], axis=0)
    return CaseVolumes(data, imgs[0].affine, imgs[0].get_zooms(), "python")


def load_case_volumes(case: BratsCase) -> CaseVolumes:
    """Load the four modalities as a float32 (4, X, Y, Z) stack.

    Returns ``(data, affine, zooms)`` (a :class:`CaseVolumes`, whose
    ``route`` says which decoder ran).  All modalities must share a shape
    (else ``ValueError``); the affine and zooms of the first modality are
    used (BraTS volumes are co-registered on a 1 mm isotropic grid).  The
    native decoder runs first; any other failure of it (library
    unavailable, a file it cannot decode, a qform-only header) takes the
    pure-Python route, which gives the same values bit for bit.
    """
    try:
        return load_case_volumes_native(case)
    except IOError:
        return load_case_volumes_python(case)


class CasePrefetcher:
    """Overlap host-side NIfTI decode with device compute.

    Iterates ``(case, loaded)`` where ``loaded`` is
    :func:`load_case_volumes`'s result: case *k+1*'s decode (up to
    ``depth`` cases ahead) runs on a background thread while the consumer
    segments case *k*.  Each iteration has its own thread pool, so the
    prefetcher can be iterated again and broken out of; a decode error is
    raised where its case is yielded.

    Usage::

        for case, loaded in CasePrefetcher(cases):
            seg, info = engine.predict_case(case, loaded=loaded)
    """

    def __init__(self, cases: Sequence[BratsCase], depth: int = 1):
        self._cases = list(cases)
        self._depth = max(1, depth)

    def __iter__(self):
        pool = cf.ThreadPoolExecutor(max_workers=self._depth)
        pending = collections.deque()
        idx = 0
        try:
            while idx < len(self._cases) or pending:
                while idx < len(self._cases) and len(pending) <= self._depth:
                    case = self._cases[idx]
                    pending.append((case, pool.submit(load_case_volumes, case)))
                    idx += 1
                case, fut = pending.popleft()
                yield case, fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self) -> int:
        return len(self._cases)
