"""Segmentation overlay rendering and prediction-vs-GT comparison grids.

Capability parity with upstream scripts/visualize_segmentation.py
(per-modality RGB overlays, ref :19-58) and
upstream compare_segmentations.py (GT/pred/diff panels + label bars,
ref :12-96).  Vectorized blending (no per-label Python loops over channels)
and headless-safe matplotlib (Agg), imported when a figure is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.brats import MODALITIES, find_cases, load_case_volumes
from ..io import nifti

__all__ = ["LABEL_COLORS", "create_rgb_overlay", "visualize_case", "compare_segmentations"]

#: label → RGB (NCR red, ED green, ET blue — ET accepted as 3 or 4).
LABEL_COLORS: Dict[int, Sequence[float]] = {
    1: (1.0, 0.0, 0.0),
    2: (0.0, 1.0, 0.0),
    3: (0.0, 0.0, 1.0),
    4: (0.0, 0.0, 1.0),
}


def create_rgb_overlay(
    mri_slice: np.ndarray, seg_slice: np.ndarray, alpha: float = 0.4
) -> np.ndarray:
    """Grayscale slice + label overlay → (H, W, 3) float RGB in one pass."""
    lo, hi = float(mri_slice.min()), float(mri_slice.max())
    norm = (mri_slice - lo) / (hi - lo + 1e-8)
    rgb = np.repeat(norm[..., None], 3, axis=-1)
    seg = np.round(seg_slice).astype(np.int32)
    color = np.zeros(seg.shape + (3,), np.float32)
    for label, c in LABEL_COLORS.items():
        color[seg == label] = c
    mask = (seg > 0)[..., None]
    return np.where(mask, (1 - alpha) * rgb + alpha * color, rgb)


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend, imported at first
    use: ``create_rgb_overlay`` and the package's other modules need no
    matplotlib, and a machine without it fails only here, with a message."""
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise SystemExit("visualize / compare draw with matplotlib, which is not installed "
                         f"here ({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _slice_indices(seg: np.ndarray, num_slices: int) -> List[int]:
    """Axial slices spanning the tumor extent (fall back to volume center)."""
    zs = np.nonzero(seg.any(axis=(0, 1)))[0]
    if zs.size == 0:
        mid = seg.shape[2] // 2
        half = num_slices // 2
        return list(range(max(0, mid - half), min(seg.shape[2], mid + half + 1)))[:num_slices]
    return list(np.unique(np.linspace(zs[0], zs[-1], num_slices).astype(int)))


def visualize_case(
    mri_dir,
    seg_path,
    output_dir,
    num_slices: int = 9,
    alpha: float = 0.4,
    modalities: Sequence[str] = MODALITIES,
) -> List[str]:
    """Per-modality overlay grids; returns the written PNG paths."""
    plt = _pyplot()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cases = find_cases(mri_dir, recursive=False)
    if not cases:
        raise FileNotFoundError(f"no complete BraTS case in {mri_dir}")
    data, _, _ = load_case_volumes(cases[0])
    seg = np.round(nifti.load(seg_path).get_fdata(dtype=np.float32)).astype(np.int32)
    indices = _slice_indices(seg, num_slices)
    cols = 3
    rows = int(np.ceil(len(indices) / cols))

    written = []
    for mod in modalities:
        # data is ALWAYS in canonical channel order; index by name so a
        # subset/reordered `modalities` arg doesn't mislabel the panels
        mi = MODALITIES.index(mod)
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
        axes = np.atleast_1d(axes).ravel()
        for ax in axes:
            ax.axis("off")
        for ax, z in zip(axes, indices):
            ax.imshow(
                np.rot90(create_rgb_overlay(data[mi, :, :, z], seg[:, :, z], alpha))
            )
            ax.set_title(f"{mod.upper()} z={z}", fontsize=9)
        fig.suptitle(f"{cases[0].case_id} — {mod.upper()} with segmentation overlay")
        out = output_dir / f"{cases[0].case_id}_{mod}_overlay.png"
        fig.savefig(out, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(str(out))
    return written


def compare_segmentations(
    gt_path,
    pred_path,
    output_path,
    background_path=None,
    num_slices: int = 5,
) -> str:
    """Side-by-side GT / prediction / difference grid + label-volume bars.

    Difference coloring: yellow = false positive (pred only), magenta =
    false negative (GT only), white = label disagreement on shared voxels.
    """
    plt = _pyplot()
    gt = np.round(nifti.load(gt_path).get_fdata(dtype=np.float32)).astype(np.int32)
    pred_img = nifti.load(pred_path)
    pred = np.round(pred_img.get_fdata(dtype=np.float32)).astype(np.int32)
    if gt.shape != pred.shape:
        raise ValueError(f"shape mismatch {gt.shape} vs {pred.shape}")
    bg = (
        nifti.load(background_path).get_fdata(dtype=np.float32)
        if background_path
        else None
    )
    if bg is not None and bg.shape != gt.shape:
        raise ValueError(
            f"background shape {bg.shape} does not match segmentation {gt.shape}"
        )
    indices = _slice_indices(gt | pred, num_slices)

    fig, axes = plt.subplots(len(indices), 3, figsize=(12, 4 * len(indices)))
    axes = np.atleast_2d(axes)
    for row, z in enumerate(indices):
        base = bg[:, :, z] if bg is not None else np.zeros_like(gt[:, :, z], np.float32)
        axes[row, 0].imshow(np.rot90(create_rgb_overlay(base, gt[:, :, z])))
        axes[row, 0].set_title(f"Ground truth z={z}", fontsize=9)
        axes[row, 1].imshow(np.rot90(create_rgb_overlay(base, pred[:, :, z])))
        axes[row, 1].set_title(f"Prediction z={z}", fontsize=9)

        g, p = gt[:, :, z], pred[:, :, z]
        diff = np.zeros(g.shape + (3,), np.float32)
        diff[(p > 0) & (g == 0)] = (1, 1, 0)  # false positive
        diff[(g > 0) & (p == 0)] = (1, 0, 1)  # false negative
        diff[(g > 0) & (p > 0) & (g != p)] = (1, 1, 1)  # label mismatch
        axes[row, 2].imshow(np.rot90(diff))
        axes[row, 2].set_title("Difference (FP yellow / FN magenta)", fontsize=9)
        for ax in axes[row]:
            ax.axis("off")

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=110, bbox_inches="tight")
    plt.close(fig)

    # label distribution bars
    bars_path = output_path.with_name(output_path.stem + "_labels.png")
    labels = sorted(set(np.unique(gt)) | set(np.unique(pred)))
    labels = [l for l in labels if l != 0]
    gt_counts = [int((gt == l).sum()) for l in labels]
    pred_counts = [int((pred == l).sum()) for l in labels]
    x = np.arange(len(labels))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(x - 0.2, gt_counts, width=0.4, label="ground truth")
    ax.bar(x + 0.2, pred_counts, width=0.4, label="prediction")
    ax.set_xticks(x, [f"label {l}" for l in labels])
    ax.set_ylabel("voxels")
    ax.legend()
    fig.savefig(bars_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return str(output_path)
