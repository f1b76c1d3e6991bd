"""Volume resampling (trilinear / nearest) on tensors.

The port's counterpart of the reference's ``pre/resample.py``: used where
predicted maps must be brought back to another voxel grid (the upstream
``save_segmentation_nifti_from_softmax(..., interpolation_order=1,
interpolation_order_z=0)``).  For BraTS (1 mm in = 1 mm out) this is an
identity, but any grid is supported.

Coordinate convention matches ``skimage.transform.resize`` (what nnU-Net's
``resample_data_or_seg`` uses): center-aligned sampling,
``src = (dst + 0.5) * in_size / out_size - 0.5``, edge-clamped.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["resize_trilinear", "resize_nearest"]


def _src_coords(out_size: int, in_size: int, device, dtype=torch.float32) -> torch.Tensor:
    scale = in_size / out_size
    return (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * scale - 0.5


def _as_tensor(vol: Union[np.ndarray, torch.Tensor], device) -> torch.Tensor:
    """``vol`` on ``device`` (``None``: the card), without a copy when it is
    already a tensor there."""
    t = vol if isinstance(vol, torch.Tensor) else torch.from_numpy(np.asarray(vol))
    return t.to(resolve_device(device))


def resize_trilinear(vol, new_shape: Tuple[int, int, int], device=None) -> torch.Tensor:
    """Trilinear resize of the trailing 3 axes of ``vol`` (any leading axes).

    Separable: three 1-D lerps, each two gathers and a weighted add, in
    ``vol``'s floating dtype.  ``vol`` may be a numpy array or a tensor; the
    work runs on ``device`` (``None``: the card, ``"cpu"`` when asked for).
    """
    out = _as_tensor(vol, device)
    ndim = out.ndim
    for i, target in enumerate(new_shape):
        axis = ndim - 3 + i
        in_size = out.shape[axis]
        if in_size == target:
            continue
        c = _src_coords(target, in_size, out.device)
        lo = torch.clamp(torch.floor(c), 0, in_size - 1).long()
        hi = torch.clamp(lo + 1, 0, in_size - 1)
        w = torch.clamp(c - lo.to(c.dtype), 0.0, 1.0)
        shape = [1] * ndim
        shape[axis] = target
        w = w.reshape(shape).to(out.dtype)
        out = out.index_select(axis, lo) * (1 - w) + out.index_select(axis, hi) * w
    return out


def resize_nearest(vol, new_shape: Tuple[int, int, int], device=None) -> torch.Tensor:
    """Nearest-neighbour resize of the trailing 3 axes (labels / masks);
    half-way coordinates round to even, as the reference's ``jnp.round``."""
    out = _as_tensor(vol, device)
    ndim = out.ndim
    for i, target in enumerate(new_shape):
        axis = ndim - 3 + i
        in_size = out.shape[axis]
        if in_size == target:
            continue
        c = _src_coords(target, in_size, out.device)
        idx = torch.clamp(torch.round(c), 0, in_size - 1).long()
        out = out.index_select(axis, idx)
    return out
