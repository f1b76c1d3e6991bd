"""Sliding-window inference: Gaussian-blended patches, mirror TTA, folds.

Counterpart of ``braintpu/infer/sliding_window.py``: nnU-Net's recipe of
128^3 patches at 50 % overlap (:mod:`.gaussian`), each patch forwarded as
chunks of mirror copies batched along N, every fold on each chunk, and the
sigmoid region probabilities blended into the volume with the Gaussian
importance map.  The reference's ``lax.scan``s over patches, mirror chunks
and folds are Python loops here.  The blended sum and the weight sum are
two f32 tensors on the volume's device, updated in place on each patch's
slice; the loop reads nothing back to the host.

The order of the f32 sums is the reference's: within a chunk the folds'
sigmoids are summed per mirror copy, each copy is flipped back, the chunk
is summed and added to the patch's sum, which is divided by folds x mirrors
before it is weighted and added to the volume.  Any mirror chunk that
divides the mirror count gives the same result up to that summation order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.unet3d import UNetConfig, apply_unet
from .gaussian import gaussian_importance_map, patch_grid

__all__ = [
    "MIRROR_COMBOS",
    "mirror_flag_groups",
    "default_mirror_chunk",
    "sliding_window_predict",
    "predict_probs",
    "region_probs_to_labels",
    "stack_folds",
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


def _map_trees(fn, *trees):
    """``fn`` over the leaves of same-structured dict/list/tuple trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_trees(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map_trees(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack_leaf(*xs):
    if all(isinstance(x, np.ndarray) for x in xs):
        return np.stack(xs)
    ts = [torch.as_tensor(x) for x in xs]
    dev = next((t.device for t in ts if t.device.type != "cpu"), torch.device("cpu"))
    return torch.stack([t.to(dev) for t in ts])


def stack_folds(fold_params: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-fold parameter trees along a new leading axis, leaf by leaf.

    Numpy leaves stack with numpy and CPU tensors with torch, both on the
    host; a leaf with a tensor on a card stacks on that card (host leaves
    beside it are copied there).  The port's engines keep folds as lists
    (``fold_params``) and never call this; it is the reference's API.
    """
    return _map_trees(_stack_leaf, *fold_params)


def mirror_flag_groups(combos, group_size: int) -> np.ndarray:
    """(G, B, 3) boolean flip flags covering ``combos`` in groups of B."""
    flags = np.zeros((len(combos), 3), bool)
    for i, axes in enumerate(combos):
        for ax in axes:
            flags[i, ax] = True
    g = max(1, group_size)
    if len(combos) % g:
        raise ValueError(f"mirror_chunk={g} must divide the mirror count {len(combos)}")
    return flags.reshape(len(combos) // g, g, 3)


def default_mirror_chunk(cfg: UNetConfig) -> int:
    """Mirror copies per forward: 8 for the base width, 4 for the
    double-width encoder (the reference's choice)."""
    return 8 if cfg.encoder_scale <= 1 else 4


def _flip(x: torch.Tensor, flags) -> torch.Tensor:
    """Flip a (D, H, W, C) tensor along the spatial axes whose flag is set."""
    dims = [a for a in range(3) if flags[a]]
    return torch.flip(x, dims) if dims else x


@torch.inference_mode()
def sliding_window_predict(
    fold_params: Sequence[Dict[str, Any]],
    volume: torch.Tensor,
    grid: np.ndarray,
    gaussian: torch.Tensor,
    cfg: UNetConfig,
    num_mirror: int = 8,
    folded: bool = False,
    mirror_chunk: int = 8,
) -> torch.Tensor:
    """Gaussian-blended, mirror-TTA, fold-averaged region probabilities.

    Args:
      fold_params: one parameter dict per fold (on the volume's device).
      volume: (X, Y, Z, C) preprocessed volume, every axis >= the patch.
      grid: (P, 3) patch start corners (host integers, :func:`patch_grid`).
      gaussian: (pd, ph, pw) f32 importance map.
      num_mirror: 1 (no TTA) or 8 (full mirror TTA).
      folded: the params have BatchNorm folded into the convs.
      mirror_chunk: mirror copies per forward (the batch N); must divide
        the mirror count.

    Returns:
      (X, Y, Z, K) f32 probabilities (sigmoid regions, fold-averaged).
    """
    if num_mirror not in (1, 8):
        raise ValueError(f"num_mirror={num_mirror} unsupported: 1 (no TTA) or 8 (full mirror TTA)")
    combos = MIRROR_COMBOS[:1] if num_mirror == 1 else MIRROR_COMBOS
    pd, ph, pw = cfg.patch_size
    K = cfg.num_classes
    X, Y, Z, _ = volume.shape
    B = min(mirror_chunk, len(combos))
    flag_groups = mirror_flag_groups(combos, B).tolist()
    dev = volume.device
    gauss = gaussian.to(device=dev, dtype=torch.float32)[..., None]  # (pd, ph, pw, 1)

    acc = torch.zeros((X, Y, Z, K), dtype=torch.float32, device=dev)
    wsum = torch.zeros((X, Y, Z, 1), dtype=torch.float32, device=dev)
    probs = torch.empty((pd, ph, pw, K), dtype=torch.float32, device=dev)
    group_sum = torch.empty((B, pd, ph, pw, K), dtype=torch.float32, device=dev)
    for x0, y0, z0 in np.asarray(grid).tolist():
        window = (slice(x0, x0 + pd), slice(y0, y0 + ph), slice(z0, z0 + pw))
        patch = volume[window]
        probs.zero_()
        for flags in flag_groups:
            batch = torch.stack([_flip(patch, f) for f in flags])  # (B, pd, ph, pw, C)
            group_sum.zero_()
            for params in fold_params:
                group_sum += torch.sigmoid(apply_unet(params, batch, cfg, folded=folded))
            for b, f in enumerate(flags):
                if any(f):
                    group_sum[b] = _flip(group_sum[b], f)
            probs += group_sum.sum(dim=0)
        probs /= len(fold_params) * len(combos)
        acc[window] += probs * gauss
        wsum[window] += gauss
    return acc / wsum


def predict_probs(
    fold_params: Sequence[Dict[str, Any]],
    volume_cxyz: torch.Tensor,
    cfg: UNetConfig,
    step_size: float = 0.5,
    tta: bool = True,
    folded: bool = False,
    mirror_chunk: Optional[int] = None,
) -> torch.Tensor:
    """(C, X, Y, Z) volume (every axis >= the patch) -> (X, Y, Z, K) probs.

    The patch grid and the Gaussian are computed on the host (cached)."""
    vol = volume_cxyz.movedim(0, -1).contiguous()
    grid = patch_grid(tuple(vol.shape[:3]), cfg.patch_size, step_size)
    gauss = torch.tensor(gaussian_importance_map(tuple(cfg.patch_size)), device=vol.device)
    return sliding_window_predict(
        fold_params, vol, grid, gauss, cfg, num_mirror=8 if tta else 1, folded=folded,
        mirror_chunk=mirror_chunk or default_mirror_chunk(cfg))


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
