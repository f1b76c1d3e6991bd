"""Dice / IoU / sensitivity / specificity on BraTS label maps.

Counterpart of ``braintpu/metrics/segmentation.py``.  Two routes to the
same exact integer confusion counts of every label and compound region
(WT=[1,2,3], TC=[1,3], ET=[3], BraTS-2025 space), with the reference
evaluator's 1e-8 smoothing constant:

* host (numpy arrays): one bincount pass builds the pred x gt label
  co-occurrence matrix, and each region's counts are sums over it;
* device (:func:`confusion_counts`, torch tensors): one pass of region
  membership masks on the tensors' device, counted in int64 (the
  reference's jitted pass sums in f32, exact below 2^24 voxels).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "COMPOUND_REGIONS",
    "SegMetrics",
    "confusion_counts",
    "metrics_from_counts",
    "evaluate_pair",
    "evaluate_segmentation",
]

_EPS = 1e-8

#: BraTS compound regions in 2025 label space (1=NCR, 2=ED, 3=ET).
COMPOUND_REGIONS: Dict[str, Tuple[int, ...]] = {
    "WT": (1, 2, 3),
    "TC": (1, 3),
    "ET": (3,),
}


@dataclass(frozen=True)
class SegMetrics:
    dice: float
    iou: float
    sensitivity: float
    specificity: float
    tp: int
    fp: int
    fn: int
    tn: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "dice": self.dice,
            "iou": self.iou,
            "sensitivity": self.sensitivity,
            "specificity": self.specificity,
            "tp": self.tp,
            "fp": self.fp,
            "fn": self.fn,
            "tn": self.tn,
        }


def _as_tensor(x, device: Union[None, str, torch.device]) -> torch.Tensor:
    """A tensor stays on its device; a host array goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.kind == "u" and a.dtype != np.uint8:
        a = a.astype(np.int64)  # torch has no full uint16/32/64 support
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def _region_masks(seg: torch.Tensor, regions: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """(R, V) boolean membership of each voxel in each region."""
    flat = seg.reshape(-1)
    rows = []
    for labels in regions:
        m = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
        for label in labels:
            m |= flat == label
        rows.append(m)
    return torch.stack(rows)


def confusion_counts(
    pred, gt, regions: Tuple[Tuple[int, ...], ...],
    device: Union[None, str, torch.device] = None,
) -> torch.Tensor:
    """(R, 4) int64 [tp, fp, fn, tn] per region, in one pass on the device.

    Tensors are counted on ``pred``'s device (``gt`` follows it); numpy
    inputs go to ``device`` (``None``: the card, raising when there is none).
    """
    p = _as_tensor(pred, device)
    g = _as_tensor(gt, p.device).to(p.device)
    if p.numel() != g.numel():
        raise ValueError(f"pred has {p.numel()} voxels, gt {g.numel()}")
    pm, gm = _region_masks(p, regions), _region_masks(g, regions)
    tp = (pm & gm).sum(dim=1)
    fp = (pm & ~gm).sum(dim=1)
    fn = (~pm & gm).sum(dim=1)
    tn = p.numel() - tp - fp - fn
    return torch.stack([tp, fp, fn, tn], dim=1)


def _region_counts_np(
    pred: np.ndarray, gt: np.ndarray, regions: Tuple[Tuple[int, ...], ...]
) -> np.ndarray:
    """(R, 4) [tp, fp, fn, tn] per region from one bincount pass (numpy).

    Same integer counts as :func:`confusion_counts`: builds the (M, M)
    pred×gt label co-occurrence matrix in a single pass, then each
    region's counts are sums over its member/non-member blocks.
    """
    p = np.asarray(pred).reshape(-1)
    g = np.asarray(gt).reshape(-1)
    top = max(int(p.max(initial=0)), int(g.max(initial=0)),
              max((l for r in regions for l in r), default=0))
    M = top + 1
    if M * top + top < 256 and p.min(initial=0) >= 0 and g.min(initial=0) >= 0:
        # BraTS labels are tiny: build the pair index in uint8 (no overflow
        # for M*top+top < 256).  The previous int64 path allocated four
        # ~70 MB temporaries per 240³ case — first-touch page faults made
        # the one-pass bincount cost ~3 s in the pipeline; uint8 temporaries
        # are 9 MB and measure ~0.15 s for identical counts.
        idx = p.astype(np.uint8) * np.uint8(M)
        idx += g.astype(np.uint8)
        c = np.bincount(idx, minlength=M * M).reshape(M, M)
    else:
        c = np.bincount(
            p.astype(np.int64) * M + g.astype(np.int64), minlength=M * M
        ).reshape(M, M)
    V = int(c.sum())
    out = np.zeros((len(regions), 4), np.int64)
    for i, labels in enumerate(regions):
        m = np.zeros(M, bool)
        m[list(labels)] = True
        tp = int(c[m][:, m].sum())
        fp = int(c[m][:, ~m].sum())
        fn = int(c[~m][:, m].sum())
        out[i] = (tp, fp, fn, V - tp - fp - fn)
    return out


def metrics_from_counts(tp: float, fp: float, fn: float, tn: float) -> SegMetrics:
    dice = (2 * tp) / (2 * tp + fp + fn + _EPS)
    iou = tp / (tp + fp + fn + _EPS)
    sens = tp / (tp + fn + _EPS)
    spec = tn / (tn + fp + _EPS)
    return SegMetrics(
        float(dice), float(iou), float(sens), float(spec), int(tp), int(fp), int(fn), int(tn)
    )


def evaluate_pair(pred, gt, label, device: Union[None, str, torch.device] = None) -> SegMetrics:
    """Metrics for a single label value (reference `calculate_metrics`),
    through :func:`confusion_counts` (numpy inputs go to ``device``).

    The ratios are float64 of the exact counts, as in
    :func:`evaluate_segmentation`; the reference's come from its f32 counts.
    """
    counts = confusion_counts(pred, gt, ((int(label),),), device)
    return metrics_from_counts(*counts[0].tolist())


def evaluate_segmentation(
    pred: np.ndarray,
    gt: np.ndarray,
    labels: Sequence[int] = (1, 2, 3),
) -> Dict:
    """Full evaluation: per-label + WT/TC/ET compounds + mean Dice.

    Labels are in BraTS-2025 space by default.  Returns the structured dict
    the pipeline persists (`per_label`, `compound`, `mean_dice`).  Numpy
    inputs are counted on the host; a torch tensor on either side is
    counted by :func:`confusion_counts` on its device.
    """
    region_keys = [f"label_{l}" for l in labels] + list(COMPOUND_REGIONS)
    region_defs = tuple([(int(l),) for l in labels]) + tuple(
        COMPOUND_REGIONS[k] for k in COMPOUND_REGIONS
    )
    if isinstance(pred, torch.Tensor) or isinstance(gt, torch.Tensor):
        dev = (pred if isinstance(pred, torch.Tensor) else gt).device
        counts = confusion_counts(_as_tensor(pred, dev), gt, region_defs).cpu().numpy()
    else:
        counts = _region_counts_np(pred, gt, region_defs)
    results = {k: metrics_from_counts(*c) for k, c in zip(region_keys, counts)}
    mean_dice = float(
        np.mean([results[k].dice for k in COMPOUND_REGIONS])
    )
    return {
        "per_label": {int(l): results[f"label_{l}"].as_dict() for l in labels},
        "compound": {k: results[k].as_dict() for k in COMPOUND_REGIONS},
        "mean_dice": mean_dice,
    }
