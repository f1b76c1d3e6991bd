"""Inference preprocessing: crop to nonzero, masked z-score, pad; resampling."""

from .preprocess import (
    CropInfo,
    PreprocessResult,
    compute_brain_mask,
    crop_to_nonzero,
    pad_to_patch,
    preprocess_case,
    zscore_masked,
    zscore_masked_np,
)
from .resample import resize_nearest, resize_trilinear

__all__ = [
    "CropInfo",
    "PreprocessResult",
    "compute_brain_mask",
    "crop_to_nonzero",
    "pad_to_patch",
    "preprocess_case",
    "zscore_masked",
    "zscore_masked_np",
    "resize_nearest",
    "resize_trilinear",
]
