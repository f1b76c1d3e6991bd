"""Segmentation post-processing (host, numpy + scipy): the KAIST
enhancing-tumor minimum-size rule and largest-component filtering.

Copy of ``braintpu/labels/postprocess.py``.  The ET rule: if the
enhancing-tumor region has fewer than 200 voxels in total, those voxels are
relabelled as tumor core (internal label 2), because a tiny predicted ET is
usually noise -- nnU-Net's ``apply_threshold_to_folder(..., 200, 2)``.
Connected components are a sequential pass over one volume and stay on the
host (``scipy.ndimage.label``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage as ndi

__all__ = ["et_min_size_postprocess", "keep_largest_component"]

#: 26-connectivity structuring element for 3D components.
STRUCT_26 = np.ones((3, 3, 3), dtype=bool)


def et_min_size_postprocess(
    seg: np.ndarray,
    et_label: int = 3,
    replace_with: int = 2,
    min_voxels: int = 200,
) -> np.ndarray:
    """If total ET volume < ``min_voxels``, convert ET voxels to ``replace_with``."""
    seg = np.asarray(seg)
    et_mask = seg == et_label
    n = int(et_mask.sum())
    if 0 < n < min_voxels:
        out = seg.copy()
        out[et_mask] = replace_with
        return out
    return seg


def keep_largest_component(
    mask: np.ndarray, connectivity_26: bool = True
) -> Tuple[np.ndarray, int]:
    """Keep only the largest connected component of a boolean mask.

    Returns ``(filtered_mask, num_components)``; components touch through
    faces, edges and corners with ``connectivity_26``, through faces only
    without it.  Of two largest components of one size the first label wins.
    """
    mask = np.asarray(mask, dtype=bool)
    labeled, n = ndi.label(mask, structure=STRUCT_26 if connectivity_26 else None)
    if n <= 1:
        return mask, n
    sizes = np.bincount(labeled.ravel())
    sizes[0] = 0
    return labeled == int(np.argmax(sizes)), n
