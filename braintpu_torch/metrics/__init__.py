"""Segmentation metrics."""

from .segmentation import (
    COMPOUND_REGIONS,
    SegMetrics,
    confusion_counts,
    evaluate_pair,
    evaluate_segmentation,
    metrics_from_counts,
)

__all__ = [
    "COMPOUND_REGIONS",
    "SegMetrics",
    "confusion_counts",
    "evaluate_pair",
    "evaluate_segmentation",
    "metrics_from_counts",
]
