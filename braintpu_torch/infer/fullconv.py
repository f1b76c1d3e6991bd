"""Whole-volume fully-convolutional inference (fullconv mode).

Counterpart of ``braintpu/infer/fullconv.py`` (``fullconv_predict``,
``predict_probs_fullconv``).  ``MIRROR_COMBOS`` and
``region_probs_to_labels`` live in :mod:`.sliding_window`, as in the
reference, and are re-exported here.

The cropped volume is padded to a multiple of ``2**num_pool`` per axis, and
every fold runs one forward per mirror flip over the whole volume.  The
reference's ``lax.scan``s over flips and folds are Python loops here that
accumulate sigmoid region probabilities into one f32 tensor on the device,
in the reference's order (folds summed within a flip, flipped back, added).

The axial-attention families have positional embeddings bound to the patch
shape and are refused here, as in the reference: they run in sliding mode.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..models.unet3d import UNetConfig, apply_unet
from .sliding_window import MIRROR_COMBOS, region_probs_to_labels

__all__ = [
    "MIRROR_COMBOS",
    "fullconv_predict",
    "predict_probs_fullconv",
    "region_probs_to_labels",
]


def _apply_flips(x: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """Flip a (B, X, Y, Z, C) tensor along the given spatial axes."""
    return torch.flip(x, [a + 1 for a in axes]) if axes else x


@torch.inference_mode()
def fullconv_predict(
    fold_params: Sequence[Dict[str, Any]],
    volume: torch.Tensor,
    cfg: UNetConfig,
    num_mirror: int = 8,
    folded: bool = False,
) -> torch.Tensor:
    """Mirror-TTA, fold-averaged region probabilities over the whole volume.

    Args:
      fold_params: one parameter dict per fold (on the volume's device).
      volume: (X, Y, Z, C) preprocessed volume, or a (B, X, Y, Z, C) batch
        of same-bucket volumes, every spatial axis a multiple of
        ``2**cfg.num_pool``.
      num_mirror: 1 (no TTA) or 8 (full mirror TTA).
      folded: the params have BatchNorm folded into the convs (see
        ``models.unet3d.apply_unet``; False by default, as in the reference).

    Returns:
      (X, Y, Z, K) f32 sigmoid probabilities averaged over folds x mirrors,
      or (B, X, Y, Z, K) for a batch (each case's own, as its single call).
    """
    if cfg.axial_attention:
        raise ValueError(
            "fullconv mode is incompatible with the axial-attention variant "
            "(patch-shape-bound positional embeddings); use sliding-window")
    squeeze = volume.dim() == 4
    x = volume[None] if squeeze else volume
    div = 2**cfg.num_pool
    B, X, Y, Z, _ = x.shape
    if any(s % div for s in (X, Y, Z)):
        raise ValueError(
            f"volume shape {(X, Y, Z)} must be a multiple of {div}; "
            "preprocess with preprocess_case(..., pad_multiple=2**num_pool)")
    if num_mirror not in (1, 8):
        raise ValueError(f"num_mirror={num_mirror} unsupported: 1 (no TTA) or 8 (full mirror TTA)")
    combos = MIRROR_COMBOS[:1] if num_mirror == 1 else MIRROR_COMBOS
    probs = torch.zeros((B, X, Y, Z, cfg.num_classes), dtype=torch.float32, device=x.device)
    group = torch.empty_like(probs)
    for axes in combos:
        batch = _apply_flips(x, axes)
        group.zero_()
        for params in fold_params:
            group += torch.sigmoid(apply_unet(params, batch, cfg, folded=folded))
        probs += _apply_flips(group, axes)
    probs /= len(fold_params) * len(combos)
    return probs[0] if squeeze else probs


def predict_probs_fullconv(
    fold_params: Sequence[Dict[str, Any]],
    volume_cxyz: torch.Tensor,
    cfg: UNetConfig,
    tta: bool = True,
    folded: bool = False,
) -> torch.Tensor:
    """(C, X, Y, Z) volume (already multiple-of-2^pool) -> (X, Y, Z, K) probs."""
    vol = volume_cxyz.movedim(0, -1).contiguous()
    return fullconv_predict(fold_params, vol, cfg, num_mirror=8 if tta else 1, folded=folded)
