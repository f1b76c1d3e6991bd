"""Whole-volume (fullconv) and sliding-window inference and the case-level
engine."""

from .engine import InferenceEngine, ModelBundle, calculate_volumes, uncrop_labels
from .fullconv import (
    fullconv_predict,
    fullconv_predict_sharded,
    fullconv_predict_spatial,
    predict_probs_fullconv,
)
from .gaussian import gaussian_importance_map, patch_grid, sliding_window_starts
from .sliding_window import (
    MIRROR_COMBOS,
    default_mirror_chunk,
    predict_probs,
    region_probs_to_labels,
    sliding_window_predict,
    stack_folds,
)

__all__ = [
    "InferenceEngine",
    "ModelBundle",
    "calculate_volumes",
    "uncrop_labels",
    "fullconv_predict",
    "fullconv_predict_sharded",
    "fullconv_predict_spatial",
    "predict_probs_fullconv",
    "gaussian_importance_map",
    "patch_grid",
    "sliding_window_starts",
    "MIRROR_COMBOS",
    "predict_probs",
    "region_probs_to_labels",
    "sliding_window_predict",
    "stack_folds",
]
