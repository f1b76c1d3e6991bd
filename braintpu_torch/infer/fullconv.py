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

Over a mesh of ranks (:mod:`braintpu_torch.parallel`), every rank holding
the whole volume and the folds on its device:

* :func:`fullconv_predict_sharded` splits the 8 mirrors over an axis: each
  rank forwards its contiguous block of mirrors (folds in turn) and one sum
  over the axis merges the probabilities;
* :func:`fullconv_predict_spatial` splits the X axis: each rank forwards its
  slab of every mirror's volume (the forward exchanges conv halos and sums
  the GroupNorm statistics, ``models.unet3d.Sharding``), and one sum over
  the axis assembles the whole map.  A mirror that flips X hands rank ``r``
  the flipped slab of rank ``n - 1 - r``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..models.unet3d import Sharding, UNetConfig, apply_unet, sharded_forward
from .sliding_window import MIRROR_COMBOS, region_probs_to_labels

__all__ = [
    "MIRROR_COMBOS",
    "fullconv_predict",
    "fullconv_predict_sharded",
    "fullconv_predict_spatial",
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


def _fold_sum(fold_params, batch, cfg: UNetConfig, folded: bool, out: torch.Tensor):
    """``out`` = the folds' summed sigmoid probabilities of ``batch``."""
    out.zero_()
    for params in fold_params:
        out += torch.sigmoid(apply_unet(params, batch, cfg, folded=folded))
    return out


def _check_volume(volume: torch.Tensor, cfg: UNetConfig) -> Tuple[int, int, int]:
    if cfg.axial_attention:
        raise ValueError("fullconv is incompatible with the axial variant")
    div = 2**cfg.num_pool
    X, Y, Z, _ = volume.shape
    if any(s % div for s in (X, Y, Z)):
        raise ValueError(f"volume {(X, Y, Z)} must be a multiple of {div}")
    return X, Y, Z


@torch.inference_mode()
def fullconv_predict_sharded(
    fold_params: Sequence[Dict[str, Any]],
    volume: torch.Tensor,
    cfg: UNetConfig,
    mesh,
    axis: str = "data",
    folded: bool = False,
) -> torch.Tensor:
    """Mirror-TTA-parallel whole-volume ensemble over a mesh axis.

    The 8 mirror orientations are independent whole-volume forwards: rank
    ``i`` of the axis takes mirrors ``8i/n .. 8(i+1)/n - 1`` (folds in turn)
    and one sum over the axis merges the probability maps.
    ``mesh.shape[axis]`` must divide 8.  Every rank passes the whole (X, Y,
    Z, C) volume and gets the (X, Y, Z, K) probabilities.
    """
    if cfg.axial_attention:
        raise ValueError("fullconv is incompatible with the axial variant")
    n = mesh.shape[axis]
    if 8 % n:
        raise ValueError(f"mesh axis {axis}={n} must divide the 8 mirrors")
    X, Y, Z = _check_volume(volume, cfg)
    from ..parallel.collectives import all_reduce_sum

    comm = mesh.comm(axis)
    per = 8 // n
    x = volume[None]
    probs = torch.zeros((1, X, Y, Z, cfg.num_classes), dtype=torch.float32, device=x.device)
    group = torch.empty_like(probs)
    for axes in MIRROR_COMBOS[comm.index * per:(comm.index + 1) * per]:
        probs += _apply_flips(_fold_sum(fold_params, _apply_flips(x, axes), cfg, folded, group),
                              axes)
    all_reduce_sum(probs, comm, kind="probs")
    return probs[0] / (len(fold_params) * 8)


@torch.inference_mode()
def fullconv_predict_spatial(
    fold_params: Sequence[Dict[str, Any]],
    volume: torch.Tensor,
    cfg: UNetConfig,
    mesh,
    axis: str = "data",
    num_mirror: int = 8,
    folded: bool = False,
) -> torch.Tensor:
    """Whole-volume ensemble with the X axis split over a mesh axis.

    The context-parallel counterpart for one large case: each rank runs
    every fold and mirror on its slab of X, the convs exchanging one-plane
    halos and the GroupNorm / InstanceNorm statistics summed over the slabs,
    so each rank holds about ``1/n`` of the activations.  ``X`` must be a
    multiple of ``n * 2**num_pool`` so every slab boundary lies on the pool
    grid at every depth.  Every rank passes the whole (X, Y, Z, C) volume and
    gets the whole (X, Y, Z, K) probabilities.
    """
    if cfg.axial_attention:
        raise ValueError("fullconv is incompatible with the axial variant")
    n = mesh.shape[axis]
    div = 2**cfg.num_pool
    X, Y, Z = _check_volume(volume, cfg)
    if X % (n * div):
        raise ValueError(
            f"X={X} must be a multiple of mesh axis {axis}={n} × {div} "
            f"(pad the bucket to {-(-X // (n * div)) * n * div})")
    if num_mirror not in (1, 8):
        raise ValueError(f"num_mirror={num_mirror} unsupported: 1 (no TTA) or 8 (full mirror TTA)")
    from ..parallel.collectives import all_reduce_sum

    comm = mesh.comm(axis)
    S = X // n
    combos = MIRROR_COMBOS[:1] if num_mirror == 1 else MIRROR_COMBOS
    x = volume[None]
    probs = torch.zeros((1, X, Y, Z, cfg.num_classes), dtype=torch.float32, device=x.device)
    group = torch.empty((1, S, Y, Z, cfg.num_classes), dtype=torch.float32, device=x.device)
    with sharded_forward(Sharding(spatial=comm)):
        for axes in combos:
            slab = _apply_flips(x, axes)[:, comm.index * S:(comm.index + 1) * S]
            own = _fold_sum(fold_params, slab, cfg, folded, group)
            at = (n - 1 - comm.index) if 0 in axes else comm.index
            probs[:, at * S:(at + 1) * S] += _apply_flips(own, axes)
    all_reduce_sum(probs, comm, kind="probs")
    return probs[0] / (len(fold_params) * len(combos))


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
