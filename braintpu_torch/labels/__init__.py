"""Label conventions and segmentation post-processing."""

from .convert import (
    INTERNAL_ED,
    INTERNAL_ET,
    INTERNAL_NCR,
    brats2021_to_brats2025,
    brats2021_to_internal,
    brats2025_to_brats2021,
    brats2025_to_internal,
    internal_to_brats2021,
    internal_to_brats2025,
    normalize_to_brats2025,
    remap_labels,
)
from .postprocess import et_min_size_postprocess, keep_largest_component

__all__ = [
    "INTERNAL_ED",
    "INTERNAL_ET",
    "INTERNAL_NCR",
    "remap_labels",
    "internal_to_brats2021",
    "brats2021_to_internal",
    "brats2025_to_internal",
    "internal_to_brats2025",
    "brats2021_to_brats2025",
    "normalize_to_brats2025",
    "brats2025_to_brats2021",
    "et_min_size_postprocess",
    "keep_largest_component",
]
