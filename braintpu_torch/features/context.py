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
few passes as possible.  The host route is plain numpy and keeps the
feature layer runnable with zero device state; the groups that
``BRAINTPU_DEVICE_FEATURES`` routes to the context's ``device`` run the
same reductions on tensors there (:mod:`.devstats`).
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
    _device_stats: Optional[Dict[str, Dict[str, Dict]]] = None
    #: one-upload-per-case device residency (devstats.DeviceVolumes),
    #: shared by every device feature kernel; built lazily on the
    #: BRAINTPU_DEVICE_FEATURES device path only
    _device_volumes: Optional[Any] = None
    #: in-flight background upload thread (start_device_upload)
    _device_upload: Optional[Any] = None
    _mass_stats: Optional[Dict[str, Any]] = None
    _artifact_stats: Optional[Dict[str, Any]] = None
    _morph_stats: Optional[Dict[str, Any]] = None
    _paren_stats: Optional[Dict[str, Any]] = None
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
    #: device-routing decision pinned for the case at start_device_upload
    #: time (None → per-call check).  Pinning prevents a mid-case flip: if
    #: the device frees up at step 5 after the route was host at step 1, a
    #: device kernel would pay a synchronous DeviceVolumes upload.
    _device_route: Optional[frozenset] = None
    # the port's own fields, after the reference's:
    #: the device of the device feature groups (``None``: the card when one
    #: is present); ``auto`` routing takes its groups only for a CUDA device
    device: Any = None
    #: the exception the background upload raised, re-raised when the
    #: volumes are asked for
    _device_upload_error: Optional[Exception] = None

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
        device=None,
    ) -> "FeatureContext":
        return cls(
            case_id=case_id,
            modalities={k: np.asarray(v, np.float32) for k, v in modalities.items()},
            seg=np.round(np.asarray(seg)).astype(np.int32),
            affine=affine if affine is not None else np.eye(4),
            zooms=tuple(float(z) for z in zooms),
            modality_files=modality_files or {},
            device=device,
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

    def device_volumes(self):
        """Device-resident modality stack + seg + brain mask, uploaded ONCE
        per case on the context's device and shared by every device feature
        kernel (devstats.DeviceVolumes).  Joins a pending background upload
        (start_device_upload) and re-raises its error."""
        if self._device_upload is not None:
            self._device_upload.join()
            self._device_upload = None
        if self._device_upload_error is not None:
            err, self._device_upload_error = self._device_upload_error, None
            raise err
        if self._device_volumes is None:
            from .devstats import DeviceVolumes

            self._device_volumes = DeviceVolumes(
                self.modalities, self.seg, self.brain_mask("t1"), device=self.device
            )
        return self._device_volumes

    def start_device_upload(self) -> None:
        """Pin the case's device route and, when it names any group, start
        the DeviceVolumes transfer on a background thread.

        The feature runner calls this before step 1: steps 1–4 are
        host-bound, which hides the stacking and the copy, so the device
        steps find the volumes already resident instead of paying the
        upload synchronously."""
        from .devstats import DeviceVolumes, device_feature_groups

        # in the overlapped pipeline the device is claimed by the next
        # case's segmentation and 'auto' resolves to host for the WHOLE case
        self._device_route = device_feature_groups(self.device)
        if (
            self._device_volumes is not None
            or self._device_upload is not None
            or not self._device_route
        ):
            return
        import threading

        # derived host inputs compute on the calling thread (cached — the
        # steps need them anyway), so the worker only stacks + transfers
        brain = self.brain_mask("t1")

        def build() -> None:
            try:
                self._device_volumes = DeviceVolumes(
                    self.modalities, self.seg, brain, device=self.device
                ).block_until_uploaded()
            except Exception as e:  # re-raised by device_volumes()
                self._device_upload_error = e

        self._device_upload = threading.Thread(target=build, daemon=True)
        self._device_upload.start()

    def _dev_stats(self) -> Dict[str, Dict[str, Dict]]:
        """All region × modality stats (plus the normal reference and the
        step-5 quality reductions) from ONE device pass
        (features/devstats.py); computed lazily, cached for the case."""
        if self._device_stats is None:
            from .devstats import compute_case_stats

            self._device_stats = compute_case_stats(
                self.modalities, self.seg, self.brain_mask("t1"),
                dev=self.device_volumes(),
            )
        return self._device_stats

    def mass_effect_stats(self) -> Dict[str, Any]:
        """Step-2 device reductions (slab counts, CSF threshold/counts,
        peritumoral spread); cached for the case.  Only called on the
        device route of the 'mass' group."""
        if self._mass_stats is None:
            from .devstats import compute_mass_effect_stats

            self._mass_stats = compute_mass_effect_stats(
                self.modalities["t1"], self.tumor_masks["wt"],
                self.brain_mask("t1"), dev=self.device_volumes(),
            )
        return self._mass_stats

    def artifact_stats(self) -> Dict[str, Any]:
        """Step-5 artifact-detector device reductions (bias shells,
        background CVs, per-z zero counts, edge maxima, Gibbs gradient
        stats); cached per case.  Only called on the device route of the
        'artifacts' group."""
        if self._artifact_stats is None:
            from .devstats import compute_artifact_stats

            self._artifact_stats = compute_artifact_stats(
                self.modalities, self.brain_mask("t1"),
                self.tumor_masks["wt"], dev=self.device_volumes(),
            )
        return self._artifact_stats

    def morphology_stats(self) -> Dict[str, Any]:
        """Step-4 border/margin device reductions (erosion surface count,
        signed-EDT gradient stats, dilation-band T1ce means); cached per
        case.  Only called on the device route of the 'morph' group."""
        if self._morph_stats is None:
            from .devstats import compute_morphology_stats

            self._morph_stats = compute_morphology_stats(
                self.modalities["t1ce"], self.tumor_masks["wt"],
                dev=self.device_volumes(),
            )
        return self._morph_stats

    def parenchyma_stats(self) -> Dict[str, Any]:
        """Step-6 parenchyma device reductions (EDT depth field,
        deep/cortical band stats); cached per case.  Only called on the
        device route of the 'parenchyma' group."""
        if self._paren_stats is None:
            from .devstats import compute_parenchyma_stats

            self._paren_stats = compute_parenchyma_stats(
                self.modalities["t1"], self.modalities["flair"],
                self.brain_mask("t1"), self.tumor_masks["wt"],
                dev=self.device_volumes(),
            )
        return self._paren_stats

    def region_stats(self, region: str, modality: str) -> Dict:
        """Masked intensity summary for a tumor region on one sequence.

        Same schema as :func:`intensity_stats`; on the device route of the
        'stats' group all regions' stats come from a single batched device
        reduction instead of per-mask host passes.
        """
        if self._use_device_stats("stats"):
            return self._dev_stats()[region][modality]
        return intensity_stats(self.modalities[modality], self.tumor_masks[region])

    def _use_device_stats(self, group: str = None) -> bool:
        """Whether the device kernel group is active (devstats routing:
        'stats' shared-sort quantiles, 'mass', 'morph', 'artifacts',
        'parenchyma' — BRAINTPU_DEVICE_FEATURES routes them independently).
        Uses the per-case pinned route when start_device_upload ran (the
        runner's path), else the live check for the context's device."""
        if self._device_route is not None:
            return (group in self._device_route) if group else bool(self._device_route)
        from .devstats import device_features_enabled

        return device_features_enabled(group, device=self.device)

    def normal_stats(self, modality: str) -> Dict:
        """Normal-brain (non-tumor, >5th-pct) intensity reference per sequence."""
        if modality not in self._normal_stats:
            if self._use_device_stats("stats"):
                self._normal_stats[modality] = self._dev_stats()["normal"][modality]
            else:
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
