"""Inference-time preprocessing with nnU-Net ``GenericPreprocessor`` semantics.

Counterpart of ``braintpu/pre/preprocess.py``:

1. **Crop to nonzero** (host, numpy + scipy): brain mask = union over
   channels of ``vol != 0``, hole-filled; crop all channels to its bounding
   box.
2. **Pad** (host) centered (zeros, or any other ``np.pad`` mode) so every
   axis is >= the patch size and, with ``multiple=``, a multiple of it
   (fullconv buckets).
3. **Masked z-score** per channel over the brain mask, background exactly 0,
   as torch on the engine's device.

Padding comes before the z-score, as in the reference: padded voxels are
outside the mask, so the statistics and the output are unchanged.  Integer
valued volumes (BraTS NIfTIs are int16) travel to the device as int16,
which the z-score widens exactly to f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import ndimage as ndi

from ..utils.device import resolve_device

__all__ = [
    "CropInfo",
    "fill_holes",
    "compute_brain_mask",
    "crop_to_nonzero",
    "zscore_masked",
    "zscore_masked_np",
    "pad_to_patch",
    "preprocess_case",
    "PreprocessResult",
]


@dataclass(frozen=True)
class CropInfo:
    """Bounding box of the brain within the original volume (per axis [lo, hi))."""

    original_shape: Tuple[int, int, int]
    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]

    @property
    def cropped_shape(self) -> Tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def slices(self) -> Tuple[slice, slice, slice]:
        return tuple(slice(l, h) for l, h in zip(self.lo, self.hi))


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Fill interior holes of a boolean mask (connectivity 1): a hole is a
    background component not connected to the array border."""
    labeled, n = ndi.label(~mask)
    is_hole = np.ones(n + 1, dtype=bool)
    is_hole[0] = False
    for ax in range(mask.ndim):
        face = labeled.take([0, mask.shape[ax] - 1], axis=ax)
        is_hole[np.unique(face)] = False
    return mask | is_hole[labeled]


def compute_brain_mask(data: np.ndarray) -> np.ndarray:
    """Union-over-channels nonzero mask, hole-filled (bool, spatial shape)."""
    return fill_holes(np.any(np.asarray(data) != 0, axis=0))


def crop_to_nonzero(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, CropInfo]:
    """Crop a (C, X, Y, Z) stack to the brain bounding box.

    Returns ``(cropped_data, cropped_brain_mask, crop_info)``.  If the volume
    is entirely zero the full extent is kept.
    """
    data = np.asarray(data)
    mask = compute_brain_mask(data)
    if not mask.any():
        return data, mask, CropInfo(data.shape[1:], (0, 0, 0), data.shape[1:])
    lo, hi = [], []
    for ax in range(3):
        idx = np.nonzero(mask.any(axis=tuple(a for a in range(3) if a != ax)))[0]
        lo.append(int(idx[0]))
        hi.append(int(idx[-1]) + 1)
    info = CropInfo(data.shape[1:], tuple(lo), tuple(hi))
    return data[(slice(None),) + info.slices], mask[info.slices], info


def zscore_masked(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-channel z-score over ``mask`` voxels; background forced to 0.

    ``data``: (C, X, Y, Z) float or int16; ``mask``: (X, Y, Z) bool.
    nnU-Net's ``nonCT`` + ``use_mask_for_norm``:
    ``x = (x - mean) / (std + 1e-8)`` with the biased std over masked voxels.
    """
    data = data.float()
    m = mask.to(data.dtype)[None]
    n = torch.clamp(m.sum(dim=(1, 2, 3), keepdim=True), min=1.0)
    mean = (data * m).sum(dim=(1, 2, 3), keepdim=True) / n
    var = (((data - mean) * m) ** 2).sum(dim=(1, 2, 3), keepdim=True) / n
    return (data - mean) / (torch.sqrt(var) + 1e-8) * m


def zscore_masked_np(data: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Host (numpy) :func:`zscore_masked`, the same arithmetic in f32, for
    callers that need the result on the host (the training data loader)."""
    data = np.asarray(data, dtype=np.float32)
    m = np.asarray(mask, dtype=np.float32)[None]
    n = np.maximum(m.sum(axis=(1, 2, 3), keepdims=True), 1.0)
    masked = data * m
    mean = masked.sum(axis=(1, 2, 3), keepdims=True) / n
    var = (((data - mean) * m) ** 2).sum(axis=(1, 2, 3), keepdims=True) / n
    std = np.sqrt(var)
    return (data - mean) / (std + 1e-8) * m


def pad_to_patch(
    data: np.ndarray,
    patch_size: Sequence[int],
    mode: str = "constant",
    multiple: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[slice, ...]]:
    """Center-pad spatial axes of a (C, X, Y, Z) stack up to >= patch_size.

    Returns ``(padded, undo_slices)`` where ``undo_slices`` indexes the
    original extent inside the padded array (spatial axes only).  Lower pad
    = diff // 2 (nnU-Net's ``pad_nd_image``); ``mode`` is ``np.pad``'s
    (zeros by default).  ``multiple`` rounds each target axis up to a
    multiple.
    """
    spatial = np.array(data.shape[1:])
    target = np.maximum(spatial, np.array(patch_size))
    if multiple:
        target = -(-target // multiple) * multiple
    lo = (target - spatial) // 2
    hi = target - spatial - lo
    pads = [(0, 0)] + [(int(l), int(h)) for l, h in zip(lo, hi)]
    undo = tuple(slice(int(l), int(l + s)) for l, s in zip(lo, spatial))
    return np.pad(data, pads, mode=mode), undo


@dataclass
class PreprocessResult:
    """Everything inference needs downstream of preprocessing."""

    data: torch.Tensor  # (C, X', Y', Z') normalized f32, padded, on the device
    undo_slices: Tuple[slice, ...]  # crop of padding (spatial)
    crop: CropInfo  # crop of brain bbox vs original volume
    affine: Optional[np.ndarray] = None
    zooms: Optional[Tuple[float, ...]] = None


def preprocess_case(
    data: np.ndarray,
    patch_size: Sequence[int] = (128, 128, 128),
    affine: Optional[np.ndarray] = None,
    zooms: Optional[Tuple[float, ...]] = None,
    pad_multiple: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> PreprocessResult:
    """Crop -> pad -> masked z-score on ``device`` (``None``: the card; raises
    when there is none, as :func:`braintpu_torch.utils.device.resolve_device`).

    ``data``: float (C, X, Y, Z) in canonical modality order.  ``affine``
    and ``zooms`` ride along into the result unchanged.
    ``pad_multiple``: round padded axes up to this multiple (fullconv).
    """
    device = resolve_device(device)
    cropped, mask, info = crop_to_nonzero(np.asarray(data, dtype=np.float32))
    with np.errstate(invalid="ignore"):  # NaN/overflow just fail the check
        as_i16 = cropped.astype(np.int16)
    if np.array_equal(as_i16.astype(np.float32), cropped):
        cropped = as_i16
    padded_raw, undo = pad_to_patch(cropped, patch_size, multiple=pad_multiple)
    padded_mask, _ = pad_to_patch(mask[None], patch_size, multiple=pad_multiple)
    norm = zscore_masked(
        torch.from_numpy(padded_raw).to(device), torch.from_numpy(padded_mask[0]).to(device))
    return PreprocessResult(norm, undo, info, affine, zooms)
