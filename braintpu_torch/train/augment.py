"""nnU-Net-style data augmentation (the "DA" in the checkpoint trainer names).

Copy of ``braintpu/train/augment.py`` (numpy + scipy on the host): the same
transforms drawn from the same ``np.random.Generator`` in the same order, so
a seed gives the reference's patches.  Each transform is gated by its
nnU-Net default probability:

  spatial   — rotation (±30°) + isotropic scaling (0.7–1.4), image order-3,
              labels order-0
  noise     — additive gaussian, σ ∈ U(0, 0.1)
  blur      — per-channel gaussian, σ ∈ U(0.5, 1.0)
  brightness— multiplicative U(0.75, 1.25)
  contrast  — mean-preserving scale U(0.75, 1.25)
  lowres    — downsample by U(1, 2) (order 0) then order-3 upsample
  gamma     — min-max normalized power U(0.7, 1.5), optionally on the
              inverted image, retaining mean/std

Flips live in the sampler (mirror TTA symmetry).  All transforms take and
return ``(C, D, H, W)`` float32 images (+ labels for spatial).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage as ndi

__all__ = ["AugmentConfig", "augment_patch"]


@dataclass(frozen=True)
class AugmentConfig:
    p_spatial: float = 0.2
    rot_deg: float = 30.0
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_noise: float = 0.1
    noise_sigma: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast: Tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: Tuple[float, float] = (1.0, 2.0)
    p_gamma: float = 0.3
    gamma: Tuple[float, float] = (0.7, 1.5)
    p_gamma_invert: float = 0.1


def _spatial(rng, img, seg, cfg):
    """Rotation + scaling about the patch center (labels nearest-neighbor)."""
    angles = rng.uniform(-np.deg2rad(cfg.rot_deg), np.deg2rad(cfg.rot_deg), 3)
    scale = rng.uniform(*cfg.scale_range)
    cx, cy, cz = (np.asarray(img.shape[1:]) - 1) / 2.0

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[i, j] = -s
        m[j, i] = s
        m[j, j] = c
        return m

    mat = rot(angles[0], 0) @ rot(angles[1], 1) @ rot(angles[2], 2) / scale
    center = np.array([cx, cy, cz])
    offset = center - mat @ center
    img_t = np.stack(
        [
            ndi.affine_transform(ch, mat, offset=offset, order=3, mode="constant")
            for ch in img
        ]
    )
    seg_t = ndi.affine_transform(
        seg.astype(np.float32), mat, offset=offset, order=0, mode="constant"
    ).astype(seg.dtype)
    return img_t.astype(np.float32), seg_t


def augment_patch(
    rng: np.random.Generator,
    img: np.ndarray,
    seg: np.ndarray,
    cfg: Optional[AugmentConfig] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the transform set to one ``(C, D, H, W)`` patch + labels."""
    cfg = cfg or AugmentConfig()
    img = np.asarray(img, np.float32)

    if rng.random() < cfg.p_spatial:
        img, seg = _spatial(rng, img, seg, cfg)

    if rng.random() < cfg.p_noise:
        img = img + rng.normal(0.0, rng.uniform(*cfg.noise_sigma), img.shape).astype(
            np.float32
        )

    if rng.random() < cfg.p_blur:
        sig = rng.uniform(*cfg.blur_sigma)
        img = np.stack([ndi.gaussian_filter(ch, sig) for ch in img])

    if rng.random() < cfg.p_brightness:
        img = img * rng.uniform(*cfg.brightness)

    if rng.random() < cfg.p_contrast:
        f = rng.uniform(*cfg.contrast)
        mean = img.mean(axis=(1, 2, 3), keepdims=True)
        img = (img - mean) * f + mean

    if rng.random() < cfg.p_lowres:
        z = rng.uniform(*cfg.lowres_zoom)
        if z > 1.0:
            small = np.stack([ndi.zoom(ch, 1.0 / z, order=0) for ch in img])
            img = np.stack(
                [
                    ndi.zoom(ch, np.asarray(img.shape[1:]) / np.asarray(small.shape[1:]), order=3)[
                        : img.shape[1], : img.shape[2], : img.shape[3]
                    ]
                    for ch in small
                ]
            )

    if rng.random() < cfg.p_gamma:
        g = rng.uniform(*cfg.gamma)
        invert = rng.random() < cfg.p_gamma_invert
        mn = img.min(axis=(1, 2, 3), keepdims=True)
        rngv = img.max(axis=(1, 2, 3), keepdims=True) - mn + 1e-7
        mean, std = img.mean(axis=(1, 2, 3), keepdims=True), img.std(
            axis=(1, 2, 3), keepdims=True
        )
        x = (img - mn) / rngv
        if invert:
            x = 1.0 - (1.0 - x) ** g
        else:
            x = x**g
        img = x * rngv + mn
        # retain stats (nnU-Net's retain_stats=True default for BraTS)
        new_mean = img.mean(axis=(1, 2, 3), keepdims=True)
        new_std = img.std(axis=(1, 2, 3), keepdims=True) + 1e-7
        img = (img - new_mean) / new_std * std + mean

    return img.astype(np.float32), seg
