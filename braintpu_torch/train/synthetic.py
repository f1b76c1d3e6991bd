"""Synthetic BraTS-like case generator for training/e2e validation.

Copy of ``braintpu/train/synthetic.py`` (numpy + scipy), so that the port's
tests and chip smoke regenerate the same cases (e.g. seed 200,
``BraTS-SYN-00200-000``) without the reference package.

No trained weights for the original KAIST architectures are distributable,
so accuracy-bearing claims (training usefulness,
fullconv↔sliding equivalence under saturated probabilities) are proven on
*synthetic* gliomas: nested NCR/ET/ED regions with modality-specific
intensity signatures that mirror real contrast behavior
(ED bright on FLAIR/T2, ET enhancing on T1ce, NCR dark on T1ce — the same
signal semantics the original feature extractor tests for).

The generator is fully deterministic in ``seed`` and writes standard
on-disk BraTS cases (4 modalities + ``_seg``, BraTS-2025 labels: 1=NCR,
2=ED, 3=ET), so the *entire* production path — case discovery, NIfTI
decode, crop/z-score, training, checkpointing, inference, evaluation —
runs exactly as it would on real data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..io import nifti

__all__ = ["synth_case_arrays", "write_synth_case", "write_synth_dataset"]

#: baseline tissue intensity per modality (arbitrary scanner units)
_TISSUE = {"t1": 900.0, "t1ce": 950.0, "t2": 600.0, "flair": 500.0}

#: additive intensity shift per (region, modality) — sign/ordering follows
#: real glioma MR contrast (and therefore the reference's signal-label bins)
_REGION_SHIFT = {
    # ED: vasogenic edema — strongly FLAIR/T2 hyperintense, mildly T1 dark
    "ed": {"t1": -120.0, "t1ce": -60.0, "t2": 380.0, "flair": 520.0},
    # ET: contrast-enhancing rim — bright on T1ce
    "et": {"t1": 60.0, "t1ce": 650.0, "t2": 120.0, "flair": 150.0},
    # NCR: necrotic core — dark on T1/T1ce, fluid-bright on T2
    "ncr": {"t1": -320.0, "t1ce": -420.0, "t2": 300.0, "flair": 60.0},
}


def _smooth_noise(rng: np.random.Generator, shape, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    field = gaussian_filter(rng.normal(size=shape).astype(np.float32), sigma)
    field /= max(float(field.std()), 1e-6)
    return field


def synth_case_arrays(
    seed: int,
    shape: Tuple[int, int, int] = (128, 128, 112),
    noise_sigma: float = 45.0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """(modalities dict t1/t1ce/t2/flair → float32 volume, BraTS-2025 seg).

    One brain ellipsoid + one nested lumpy tumor (NCR ⊂ TC ⊂ WT) per case;
    all geometry/intensity draws come from ``seed``.
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    zz, yy, xx = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape), indexing="ij")
    center = np.asarray(shape, np.float32) / 2.0
    half_axes = np.asarray(shape, np.float32) * rng.uniform(0.36, 0.42, 3).astype(np.float32)
    brain_d = (
        ((zz - center[0]) / half_axes[0]) ** 2
        + ((yy - center[1]) / half_axes[1]) ** 2
        + ((xx - center[2]) / half_axes[2]) ** 2
    )
    brain = brain_d <= 1.0

    # tumor geometry: scaled distance field + smooth angular perturbation →
    # nested regions by decreasing thresholds of the SAME field (guaranteed
    # NCR ⊂ TC ⊂ WT, like real concentric glioma architecture)
    tc_center = center + (rng.uniform(-0.25, 0.25, 3) * half_axes).astype(np.float32)
    r_ed = float(rng.uniform(0.16, 0.24)) * float(np.min(shape))
    axis_scale = rng.uniform(0.75, 1.3, 3).astype(np.float32)
    d = np.sqrt(
        ((zz - tc_center[0]) * axis_scale[0]) ** 2
        + ((yy - tc_center[1]) * axis_scale[1]) ** 2
        + ((xx - tc_center[2]) * axis_scale[2]) ** 2
    ) / r_ed
    lump = _smooth_noise(rng, shape, sigma=6.0) * float(rng.uniform(0.08, 0.18))
    field = d + lump
    thr_tc = float(rng.uniform(0.62, 0.78))
    thr_ncr = thr_tc * float(rng.uniform(0.55, 0.75))
    wt = (field < 1.0) & brain
    tc = (field < thr_tc) & brain
    ncr = (field < thr_ncr) & brain

    seg = np.zeros(shape, np.int16)
    seg[wt] = 2  # ED
    seg[tc] = 3  # ET rim
    seg[ncr] = 1  # NCR core
    masks = {"ed": seg == 2, "et": seg == 3, "ncr": seg == 1}

    # intensities: tissue base × smooth bias field + region shifts + noise,
    # zeroed outside the brain (crop-to-nonzero and masked z-score see the
    # same support they would on a skull-stripped BraTS volume)
    modalities: Dict[str, np.ndarray] = {}
    for mod, base in _TISSUE.items():
        bias = 1.0 + 0.08 * _smooth_noise(rng, shape, sigma=24.0)
        vol = np.full(shape, base, np.float32) * bias
        for region, shift in _REGION_SHIFT.items():
            vol[masks[region]] += shift[mod]
        vol += rng.normal(0.0, noise_sigma, shape).astype(np.float32)
        vol = np.clip(vol, 1.0, None)
        vol[~brain] = 0.0
        modalities[mod] = vol.astype(np.float32)
    return modalities, seg


def write_synth_case(
    root: Path,
    case_id: str,
    seed: int,
    shape: Tuple[int, int, int] = (128, 128, 112),
    zooms: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Path:
    """Write one case as ``<root>/<case_id>/<case_id>_{mod,seg}.nii.gz``."""
    case_dir = Path(root) / case_id
    case_dir.mkdir(parents=True, exist_ok=True)
    modalities, seg = synth_case_arrays(seed, shape)
    affine = np.diag(list(zooms) + [1.0])
    affine[:3, 3] = -np.asarray(shape, np.float64) * np.asarray(zooms) / 2.0
    for mod, vol in modalities.items():
        # int16 like real BraTS exports (enables the half-width upload path)
        nifti.save(np.round(vol).astype(np.int16), case_dir / f"{case_id}_{mod}.nii.gz", affine=affine)
    nifti.save(seg, case_dir / f"{case_id}_seg.nii.gz", affine=affine)
    return case_dir


def write_synth_dataset(
    root: Path,
    n_cases: int,
    seed0: int = 0,
    shape: Tuple[int, int, int] = (128, 128, 112),
    prefix: str = "BraTS-SYN",
) -> List[Path]:
    """``n_cases`` deterministic cases under ``root``; returns case dirs."""
    return [
        write_synth_case(root, f"{prefix}-{seed0 + i:05d}-000", seed0 + i, shape)
        for i in range(n_cases)
    ]
