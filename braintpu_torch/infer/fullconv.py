"""Whole-volume fully-convolutional inference (fullconv mode).

Counterpart of ``braintpu/infer/fullconv.py`` (``fullconv_predict``,
``predict_probs_fullconv``).  It also carries the three helpers the
reference keeps in ``braintpu/infer/sliding_window.py``: ``MIRROR_COMBOS``,
the mirror flips (``_apply_flips``) and ``region_probs_to_labels``.

The cropped volume is padded to a multiple of ``2**num_pool`` per axis, and
every fold runs one forward per mirror flip over the whole volume.  The
reference's ``lax.scan``s over flips and folds are Python loops here that
accumulate sigmoid region probabilities into one f32 tensor on the device,
in the reference's order (folds summed within a flip, flipped back, added).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..models.unet3d import UNetConfig, apply_unet

__all__ = [
    "MIRROR_COMBOS",
    "fullconv_predict",
    "predict_probs_fullconv",
    "region_probs_to_labels",
]

#: All 2^3 mirror combinations over the spatial axes (nnU-Net mirror_axes=(0,1,2)).
MIRROR_COMBOS: Tuple[Tuple[int, ...], ...] = (
    (),
    (0,),
    (1,),
    (2,),
    (0, 1),
    (0, 2),
    (1, 2),
    (0, 1, 2),
)


def _apply_flips(x: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """Flip a (B, X, Y, Z, C) tensor along the given spatial axes."""
    return torch.flip(x, [a + 1 for a in axes]) if axes else x


@torch.inference_mode()
def fullconv_predict(
    fold_params: Sequence[Dict[str, Any]],
    volume: torch.Tensor,
    cfg: UNetConfig,
    num_mirror: int = 8,
    folded: bool = True,
) -> torch.Tensor:
    """Mirror-TTA, fold-averaged region probabilities over the whole volume.

    Args:
      fold_params: one parameter dict per fold (on the volume's device).
      volume: (X, Y, Z, C) preprocessed volume, every spatial axis a
        multiple of ``2**cfg.num_pool``.
      num_mirror: 1 (no TTA) or 8 (full mirror TTA).
      folded: the params have BatchNorm folded into the convs (see
        ``models.unet3d.apply_unet``).

    Returns:
      (X, Y, Z, K) f32 sigmoid probabilities averaged over folds x mirrors.
    """
    x = volume[None]
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
    return probs[0]


def predict_probs_fullconv(
    fold_params: Sequence[Dict[str, Any]],
    volume_cxyz: torch.Tensor,
    cfg: UNetConfig,
    tta: bool = True,
    folded: bool = True,
) -> torch.Tensor:
    """(C, X, Y, Z) volume (already multiple-of-2^pool) -> (X, Y, Z, K) probs."""
    vol = volume_cxyz.movedim(0, -1).contiguous()
    return fullconv_predict(fold_params, vol, cfg, num_mirror=8 if tta else 1, folded=folded)


def region_probs_to_labels(
    probs: torch.Tensor,
    region_class_order: Tuple[int, ...] = (1, 2, 3),
    threshold: float = 0.5,
) -> torch.Tensor:
    """Region probabilities -> uint8 label map, later regions overwriting earlier.

    Channel k is painted with label ``region_class_order[k]`` wherever
    ``probs[..., k] > threshold`` (nnU-Net ``regions_class_order=(1,2,3)``).
    """
    seg = torch.zeros(probs.shape[:-1], dtype=torch.uint8, device=probs.device)
    for k, label in enumerate(region_class_order):
        seg.masked_fill_(probs[..., k] > threshold, label)
    return seg
