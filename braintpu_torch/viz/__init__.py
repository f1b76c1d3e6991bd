"""Visualization & label diagnostics of the port (host, numpy and matplotlib)."""

from .diagnostics import audit_labels, format_label_audit
from .overlays import (
    LABEL_COLORS,
    compare_segmentations,
    create_rgb_overlay,
    visualize_case,
)

__all__ = [
    "audit_labels",
    "format_label_audit",
    "LABEL_COLORS",
    "compare_segmentations",
    "create_rgb_overlay",
    "visualize_case",
]
