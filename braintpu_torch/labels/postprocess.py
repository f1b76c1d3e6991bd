"""The KAIST enhancing-tumor minimum-size rule (host, numpy).

Copy of ``braintpu/labels/postprocess.py::et_min_size_postprocess``: if the
enhancing-tumor region has fewer than 200 voxels in total, those voxels are
relabelled as tumor core (internal label 2), because a tiny predicted ET is
usually noise -- nnU-Net's ``apply_threshold_to_folder(..., 200, 2)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["et_min_size_postprocess"]


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
