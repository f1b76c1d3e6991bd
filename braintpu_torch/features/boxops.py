"""Exact bounding-box-restricted morphology and distance transforms.

The feature-extraction hotspots are full-volume scipy passes over masks
that occupy a small fraction of the 240³ grid (round-3 cProfile:
``distance_transform_edt`` alone was 58 % of steps 2+4+6).  Every helper
here computes the SAME result as its full-volume counterpart — the crop
margins are chosen so no information outside the box can affect the
values actually consumed:

* ``binary_dilation_bbox``: a dilation by ``iterations`` can only reach
  ``iterations`` voxels beyond the mask, so a box padded by
  ``iterations + 1`` contains the entire result; everything outside is
  False in both views.
* ``binary_erosion_bbox``: erosion only removes voxels; outside a tight
  box the mask is all False, which equals scipy's ``border_value=0``
  treatment at the crop faces, so any pad ≥ 0 is exact.
* ``edt_bbox`` (distance INTO a mask's complement, e.g. signed-distance
  bands near a surface): exact for every voxel whose true nearest
  feature lies inside the box — guaranteed when the consumed distances
  are bounded by the pad (asserted by the caller's margin argument).

Each call site documents its margin reasoning.  This module is the port's
copy of the reference's host ``boxops``; the tests hold the features built
on it to the reference's on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

__all__ = [
    "bbox_slices",
    "binary_dilation_bbox",
    "binary_erosion_bbox",
    "edt",
]


def edt(mask: np.ndarray, sampling=None) -> np.ndarray:
    """``scipy.ndimage.distance_transform_edt`` with a native fast path.

    At unit sampling (BraTS is 1 mm isotropic) a 3-D mask goes to the native
    int32 squared EDT (``native.edt_sq``, Felzenszwalb): least squared
    distances are unique integers, so ``np.sqrt`` of them equals scipy's
    float64 output bit for bit.  Anisotropic sampling, another rank, or an
    unavailable native library take scipy.
    """
    unit = sampling is None or np.allclose(np.asarray(sampling, float), 1.0)
    if unit and np.ndim(mask) == 3:
        try:
            from ..native import edt_sq

            return np.sqrt(edt_sq(mask))
        except IOError:
            pass
    return ndimage.distance_transform_edt(mask, sampling=sampling)


def bbox_slices(
    mask: np.ndarray, pad: int = 0
) -> Optional[Tuple[slice, ...]]:
    """Tight bounding box of ``mask``'s True voxels, padded and clipped.

    Returns ``None`` for an empty mask.
    """
    if not mask.any():
        return None
    sl = []
    for ax in range(mask.ndim):
        proj = np.any(mask, axis=tuple(a for a in range(mask.ndim) if a != ax))
        idx = np.nonzero(proj)[0]
        lo = max(int(idx[0]) - pad, 0)
        hi = min(int(idx[-1]) + 1 + pad, mask.shape[ax])
        sl.append(slice(lo, hi))
    return tuple(sl)


def binary_dilation_bbox(
    mask: np.ndarray, iterations: int = 1, structure=None
) -> np.ndarray:
    """Full-shape ``binary_dilation(mask, iterations)`` via a padded box."""
    sl = bbox_slices(mask, pad=iterations + 1)
    if sl is None:
        return np.zeros_like(mask, dtype=bool)
    out = np.zeros(mask.shape, dtype=bool)
    out[sl] = ndimage.binary_dilation(
        mask[sl], iterations=iterations, structure=structure
    )
    return out


def binary_erosion_bbox(
    mask: np.ndarray, iterations: int = 1, structure=None
) -> np.ndarray:
    """Full-shape ``binary_erosion(mask, iterations)`` via a padded box."""
    sl = bbox_slices(mask, pad=1)
    if sl is None:
        return np.zeros_like(mask, dtype=bool)
    out = np.zeros(mask.shape, dtype=bool)
    out[sl] = ndimage.binary_erosion(
        mask[sl], iterations=iterations, structure=structure
    )
    return out
