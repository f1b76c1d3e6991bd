"""Inference preprocessing: crop to nonzero, masked z-score, pad; resampling."""

from .resample import resize_nearest, resize_trilinear

__all__ = ["resize_nearest", "resize_trilinear"]
