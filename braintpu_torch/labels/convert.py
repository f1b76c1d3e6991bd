"""Label-space remapping between nnU-Net internal and BraTS conventions.

Counterpart of ``braintpu/labels/convert.py`` (its host numpy path, which is
where the engine and the pipeline remap: after the labels come back from
the device).

Internal (regions export with ``region_class_order=(1,2,3)``):
0 = background, 1 = ED (WT-only), 2 = NCR (TC-not-ET), 3 = ET.
BraTS-2025: 1 = NCR, 2 = ED, 3 = ET.  BraTS-2021: 1 = NCR, 2 = ED, 4 = ET.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "INTERNAL_ED",
    "INTERNAL_NCR",
    "INTERNAL_ET",
    "remap_labels",
    "internal_to_brats2025",
    "internal_to_brats2021",
    "brats2025_to_internal",
    "brats2021_to_internal",
    "brats2021_to_brats2025",
    "brats2025_to_brats2021",
    "normalize_to_brats2025",
]

INTERNAL_ED = 1
INTERNAL_NCR = 2
INTERNAL_ET = 3

_INTERNAL_TO_2025 = (0, 2, 1, 3)  # index = internal label
_INTERNAL_TO_2021 = (0, 2, 1, 4)
_2021_TO_2025 = (0, 1, 2, 0, 3)  # label 3 unused in 2021 space
_2025_TO_2021 = (0, 1, 2, 4)
_ANY_TO_2025 = (0, 1, 2, 3, 3)  # both ET spellings (2021: 4, 2025: 3) -> 3


def remap_labels(seg, table) -> np.ndarray:
    """Remap integer labels through a lookup table (rounding floats first).

    ``table[i]`` is the output label for input label ``i``; labels outside
    the table map to 0.  Returns uint8.
    """
    seg = np.asarray(seg)
    if np.issubdtype(seg.dtype, np.floating):
        seg = np.round(seg)
    if seg.dtype == np.uint8:
        lut256 = np.zeros(256, np.uint8)
        lut256[: len(table)] = table
        return lut256[seg]
    lut = np.asarray(table, np.uint8)
    idx = np.clip(seg.astype(np.int32), 0, lut.shape[0] - 1)
    valid = (seg >= 0) & (seg < lut.shape[0])
    return np.where(valid, lut[idx], 0).astype(np.uint8)


def internal_to_brats2025(seg) -> np.ndarray:
    """nnU-Net internal [0,1,2,3] -> BraTS-2025 [0,1,2,3] (ET stays 3)."""
    return remap_labels(seg, _INTERNAL_TO_2025)


def internal_to_brats2021(seg) -> np.ndarray:
    """nnU-Net internal [0,1,2,3] -> BraTS-2021 [0,1,2,4] (ET becomes 4)."""
    return remap_labels(seg, _INTERNAL_TO_2021)


def brats2025_to_internal(seg) -> np.ndarray:
    """BraTS-2025 [0,1,2,3] -> nnU-Net internal (the remap is an involution:
    1 NCR <-> 2 internal-NCR, 2 ED <-> 1 internal-ED, ET stays 3)."""
    return remap_labels(seg, _INTERNAL_TO_2025)


def brats2021_to_internal(seg) -> np.ndarray:
    """BraTS-2021 [0,1,2,4] -> nnU-Net internal [0,1,2,3]."""
    return brats2025_to_internal(brats2021_to_brats2025(seg))


def brats2021_to_brats2025(seg) -> np.ndarray:
    """Strict BraTS-2021 -> 2025 map: ET 4 -> 3, and label 3 (unused in 2021
    space) -> 0.  Only for true 2021-space labels: it erases a 2025 ET."""
    return remap_labels(seg, _2021_TO_2025)


def brats2025_to_brats2021(seg) -> np.ndarray:
    """BraTS-2025 [0,1,2,3] -> BraTS-2021 [0,1,2,4]."""
    return remap_labels(seg, _2025_TO_2021)


def normalize_to_brats2025(seg) -> np.ndarray:
    """BraTS labels of either vintage -> 2025 space (ET spelled 3 or 4 -> 3)."""
    return remap_labels(seg, _ANY_TO_2025)
