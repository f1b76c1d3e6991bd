"""Shared state for the radiology feature-extraction pipeline.

The reference re-loads every NIfTI from disk in each of its six step scripts
(SURVEY.md §3.1 note at run_all.py; e.g.
upstream feature_extraction/step1_sequence_findings.py:392-401).
Here a single :class:`FeatureContext` holds the four modalities, the
segmentation, derived masks and normal-brain references — loaded once,
shared by every step.

Mask/stat semantics mirror upstream feature_extraction/utils.py:
* tumor masks: ncr = seg==1, ed = seg==2, et = seg∈{3,4},
  tc = seg∈{1,3,4}, wt = seg>0 (utils.py:167-183),
* brain mask: intensity > 5th percentile of nonzero voxels (utils.py:63-68),
* normal-brain reference: brain-mask ∧ non-tumor (utils.py:54-60),
* intensity stats: mean/std/min/max/median/q25/q75/voxel_count
  (utils.py:27-51).

The volume-wide reductions (percentiles, masked means) are batched into as
few passes as possible; everything is plain numpy on the host — these are
bandwidth-trivial compared to segmentation and keep the feature layer
runnable with zero device state.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..io import nifti
from ..io.brats import MODALITIES, find_cases, load_case_volumes

__all__ = [
    "intensity_stats",
    "tumor_masks_from_seg",
    "brain_mask_from",
    "FeatureContext",
    "NumpyJSONEncoder",
    "save_json",
]


def intensity_stats(data: np.ndarray, mask: np.ndarray) -> Dict:
    """Masked intensity summary (None-filled when the mask is empty)."""
    n = int(np.count_nonzero(mask))
    if n == 0:
        return {
            "mean": None,
            "std": None,
            "min": None,
            "max": None,
            "median": None,
            "q25": None,
            "q75": None,
            "voxel_count": 0,
        }
    from .boxops import bbox_slices

    # extract within the mask's bounding box: identical value multiset in
    # identical (row-major) order — for the small tumor-region masks this
    # replaces a full-grid scan per (region × sequence) extraction
    sl = bbox_slices(mask)
    values = data[sl][mask[sl]]
    # min/max ride the same partition pass as the quartiles (kth 0 and n-1)
    vmin, q25, median, q75, vmax = np.percentile(values, [0, 25, 50, 75, 100])
    return {
        "mean": float(values.mean()),
        "std": float(values.std()),
        "min": float(vmin),
        "max": float(vmax),
        "median": float(median),
        "q25": float(q25),
        "q75": float(q75),
        "voxel_count": n,
    }


def tumor_masks_from_seg(seg: np.ndarray) -> Dict[str, np.ndarray]:
    """Region masks in BraTS label space (accepts both ET=3 and ET=4)."""
    seg = np.round(seg).astype(np.int32)
    et = (seg == 3) | (seg == 4)
    ncr = seg == 1
    return {
        "background": seg == 0,
        "ncr": ncr,
        "ed": seg == 2,
        "et": et,
        "tc": ncr | et,
        "wt": seg > 0,
    }


def brain_mask_from(data: np.ndarray, threshold_percentile: float = 5) -> np.ndarray:
    if data.max() == 0:
        return data > 0
    thr = np.percentile(data[data > 0], threshold_percentile)
    return data > thr


@dataclass
class FeatureContext:
    """Loaded case + derived quantities shared across feature steps."""

    case_id: str
    modalities: Dict[str, np.ndarray]  # t1/t1ce/t2/flair → (X, Y, Z) float32
    seg: np.ndarray  # int32 labels, BraTS space
    affine: np.ndarray
    zooms: Tuple[float, float, float]
    modality_files: Dict[str, str] = field(default_factory=dict)

    _tumor_masks: Optional[Dict[str, np.ndarray]] = None
    _brain_masks: Dict[str, np.ndarray] = field(default_factory=dict)
    _dilated_wt: Dict[int, np.ndarray] = field(default_factory=dict)
    _normal_stats: Dict[str, Dict] = field(default_factory=dict)
    #: (ventricles, csf) host masks cached by step6.identify_ventricles
    _ventricle_masks: Optional[Tuple[Any, Any]] = None
    #: per-modality positive out-of-brain values (step-5 SNR + artifact
    #: detectors both need them; one gather, shared)
    _bg_values: Dict[str, np.ndarray] = field(default_factory=dict)
    #: per-modality positive voxel values (brain-mask threshold + step-5
    #: noise-floor percentile share one gather)
    _pos_values: Dict[str, np.ndarray] = field(default_factory=dict)
    #: per-region voxel counts from ONE seg bincount (dozens of call sites
    #: otherwise each pay a full-volume mask popcount)
    _region_counts: Optional[Dict[str, int]] = None

    @classmethod
    def load(cls, input_folder, segmentation_path) -> "FeatureContext":
        cases = find_cases(input_folder, recursive=False)
        if not cases:
            raise FileNotFoundError(f"no complete BraTS case in {input_folder}")
        case = cases[0]
        data, affine, zooms = load_case_volumes(case)
        seg_img = nifti.load(segmentation_path)
        seg = np.round(seg_img.get_fdata(dtype=np.float32)).astype(np.int32)
        # user-shipped files may be either BraTS vintage (2021 spells ET=4,
        # 2025 spells ET=3); the feature steps read 2025 space (step3's
        # ET-foci analysis is seg==3 by documented reference quirk).
        # Minimal rewrite — only the ET spelling differs between vintages —
        # so foreign labels (>4) keep counting toward WT (seg>0), matching
        # tumor_masks_from_seg/devstats semantics (a table remap would
        # zero them into 'normal' background)
        seg = np.where(seg == 4, 3, seg).astype(np.int32)
        return cls(
            case_id=case.case_id,
            modalities={m: data[i] for i, m in enumerate(MODALITIES)},
            seg=seg,
            affine=affine,
            zooms=tuple(float(z) for z in zooms[:3]),
            modality_files={m: str(p.name) for m, p in case.modality_paths.items()},
        )

    @classmethod
    def from_arrays(
        cls,
        modalities: Dict[str, np.ndarray],
        seg: np.ndarray,
        zooms=(1.0, 1.0, 1.0),
        case_id: str = "case",
        affine: Optional[np.ndarray] = None,
        modality_files: Optional[Dict[str, str]] = None,
    ) -> "FeatureContext":
        return cls(
            case_id=case_id,
            modalities={k: np.asarray(v, np.float32) for k, v in modalities.items()},
            seg=np.round(np.asarray(seg)).astype(np.int32),
            affine=affine if affine is not None else np.eye(4),
            zooms=tuple(float(z) for z in zooms),
            modality_files=modality_files or {},
        )

    # -- derived, cached ---------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.seg.shape

    @property
    def voxel_volume_mm3(self) -> float:
        return float(np.prod(self.zooms))

    @property
    def voxel_volume_cm3(self) -> float:
        return self.voxel_volume_mm3 / 1000.0

    @property
    def tumor_masks(self) -> Dict[str, np.ndarray]:
        if self._tumor_masks is None:
            self._tumor_masks = tumor_masks_from_seg(self.seg)
        return self._tumor_masks

    def positive_values(self, modality: str) -> np.ndarray:
        """``data[data > 0]`` for one modality, gathered once per case
        (shared by the brain-mask threshold and step 5's noise floor)."""
        if modality not in self._pos_values:
            data = self.modalities[modality]
            self._pos_values[modality] = data[data > 0]
        return self._pos_values[modality]

    def brain_mask(self, modality: str = "t1") -> np.ndarray:
        if modality not in self._brain_masks:
            # same semantics as brain_mask_from (data > 5th pct of positive
            # voxels; all-nonpositive → empty), via the shared gather
            data = self.modalities[modality]
            nz = self.positive_values(modality)
            if nz.size:
                self._brain_masks[modality] = data > np.percentile(nz, 5)
            else:
                self._brain_masks[modality] = data > 0
        return self._brain_masks[modality]

    def region_count(self, region: str) -> int:
        """Voxel count of a tumor region from one cached seg bincount."""
        if self._region_counts is None:
            # negatives clip to 0 before the bincount and are subtracted
            # back out: host masks put them in NO region (wt = seg > 0,
            # background = seg == 0); foreign labels >4 count toward wt only
            flat = self.seg.reshape(-1)
            n_neg = int((flat < 0).sum())
            counts = np.bincount(np.clip(flat, 0, None), minlength=6)
            by_label = {l: int(c) for l, c in enumerate(counts)}
            et = by_label.get(3, 0) + by_label.get(4, 0)
            ncr = by_label.get(1, 0)
            zeros = by_label.get(0, 0) - n_neg
            self._region_counts = {
                "background": zeros,
                "ncr": ncr,
                "ed": by_label.get(2, 0),
                "et": et,
                "tc": ncr + et,
                "wt": int(self.seg.size - zeros - n_neg),
            }
        return self._region_counts[region]

    def background_values(self, modality: str) -> np.ndarray:
        """Positive voxel values OUTSIDE the t1 brain mask, cached per case.

        Step 5 needs this multiset twice per modality (SNR background noise
        in ``assess_image_quality``, ghosting CV in ``detect_artifacts``) —
        each recomputation is two full-volume boolean passes + a gather.
        """
        if modality not in self._bg_values:
            data = self.modalities[modality]
            self._bg_values[modality] = data[(data > 0) & ~self.brain_mask("t1")]
        return self._bg_values[modality]

    def dilated_wt(self, iterations: int) -> np.ndarray:
        """``binary_dilation(wt, iterations)``, cached per case.

        Steps 2, 4 and 6 each need the 5- and 10-iteration expansions of
        the whole-tumor mask; each is a full-volume morphology pass
        (seconds on a 240³ grid), so recomputing per step contradicts the
        loaded-once design of this context."""
        if iterations not in self._dilated_wt:
            from .boxops import binary_dilation_bbox

            self._dilated_wt[iterations] = binary_dilation_bbox(
                self.tumor_masks["wt"], iterations=iterations
            )
        return self._dilated_wt[iterations]

    def region_stats(self, region: str, modality: str) -> Dict:
        """Masked intensity summary for a tumor region on one sequence.

        Same schema as :func:`intensity_stats`.
        """
        return intensity_stats(self.modalities[modality], self.tumor_masks[region])

    def normal_stats(self, modality: str) -> Dict:
        """Normal-brain (non-tumor, >5th-pct) intensity reference per sequence."""
        if modality not in self._normal_stats:
            data = self.modalities[modality]
            # tumor_masks["background"] is the cached seg == 0
            normal = self.brain_mask(modality) & self.tumor_masks["background"]
            self._normal_stats[modality] = intensity_stats(data, normal)
        return self._normal_stats[modality]

    def region_volume_cm3(self, region: str) -> float:
        return float(self.region_count(region) * self.voxel_volume_cm3)

    def voxel_info(self) -> Dict:
        return {
            "dimensions_mm": list(self.zooms),
            "volume_mm3": self.voxel_volume_mm3,
            "volume_cm3": self.voxel_volume_cm3,
        }

    def acquisition_details(self) -> Dict:
        shape = self.shape
        return {
            "slice_thickness_mm": float(self.zooms[2]),
            "in_plane_resolution_mm": (float(self.zooms[0]), float(self.zooms[1])),
            "voxel_size_mm": [float(d) for d in self.zooms],
            "matrix_size": (int(shape[0]), int(shape[1]), int(shape[2])),
            "num_slices": int(shape[2]),
            "description": None,
        }


class NumpyJSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def save_json(results: Dict, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, cls=NumpyJSONEncoder)
