"""Gaussian importance map and sliding-window patch grid.

Counterpart of ``braintpu/infer/gaussian.py`` (the same host numpy/scipy
code, cached).  nnU-Net weights each sliding-window patch by a Gaussian
centred on the patch (sigma = patch/8), normalised to a peak of 1, with its
zeros clamped to the smallest nonzero value; patch starts are re-spaced
evenly so that the first patch starts at 0 and the last one ends at the
volume's edge.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

__all__ = ["gaussian_importance_map", "sliding_window_starts", "patch_grid"]


@lru_cache(maxsize=8)
def gaussian_importance_map(
    patch_size: Tuple[int, int, int], sigma_scale: float = 1.0 / 8
) -> np.ndarray:
    """(D, H, W) float32 map: unit impulse at the centre, Gaussian-blurred,
    peak-normalised, zero floor clamped (nnU-Net's semantics).

    The cached array is shared by every caller: treat it as read-only."""
    imp = np.zeros(patch_size, dtype=np.float64)
    imp[tuple(s // 2 for s in patch_size)] = 1.0
    sigmas = [s * sigma_scale for s in patch_size]
    imp = gaussian_filter(imp, sigmas, mode="constant", cval=0.0)
    imp = (imp / imp.max()).astype(np.float32)
    nonzero_min = imp[imp > 0].min()
    imp[imp == 0] = nonzero_min
    return imp


@lru_cache(maxsize=128)
def sliding_window_starts(
    image_size: Tuple[int, ...], patch_size: Tuple[int, ...], step_size: float = 0.5
) -> Tuple[Tuple[int, ...], ...]:
    """Per-axis patch start offsets (nnU-Net's re-spacing formula).

    The target step is ``patch * step_size``; the actual step is stretched or
    shrunk so that the first patch starts at 0 and the last ends at the edge.
    """
    out: List[Tuple[int, ...]] = []
    for size, patch in zip(image_size, patch_size):
        if size < patch:
            raise ValueError(f"image axis {size} < patch {patch}; pad first")
        target = patch * step_size
        num = int(np.ceil((size - patch) / target)) + 1
        actual = (size - patch) / (num - 1) if num > 1 else 0.0
        out.append(tuple(int(np.round(actual * i)) for i in range(num)))
    return tuple(out)


def patch_grid(
    image_size: Sequence[int], patch_size: Sequence[int], step_size: float = 0.5
) -> np.ndarray:
    """(P, 3) int32 array of every patch's start corner, last axis fastest
    (``for a in sx for b in sy for c in sz``: the order of the accumulation)."""
    sx, sy, sz = sliding_window_starts(tuple(image_size), tuple(patch_size), step_size)
    grid = [(a, b, c) for a in sx for b in sy for c in sz]
    return np.asarray(grid, dtype=np.int32)
