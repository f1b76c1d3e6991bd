"""Training data: BraTS case -> preprocessed random-patch batches.

Copy of ``braintpu/train/data.py`` (numpy on the host): crop-to-nonzero and
the masked z-score of inference, then random patches with nnU-Net's
foreground oversampling and random mirror flips, drawn from one
``np.random.Generator`` in the reference's order, so the same seed gives
the same batches.  One case is resident at a time, round-robin over cases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..io import nifti
from ..io.brats import BratsCase, load_case_volumes
from ..labels.convert import brats2021_to_internal, brats2025_to_internal
from ..pre.preprocess import crop_to_nonzero, zscore_masked_np
from .augment import AugmentConfig, augment_patch

__all__ = ["PatchSampler", "load_training_case"]


def load_training_case(case: BratsCase) -> Tuple[np.ndarray, np.ndarray]:
    """(channels, X, Y, Z) z-scored volume + (X, Y, Z) int labels.

    Labels use the internal nnU-Net convention (0 bg, 1 ED, 2 NCR, 3 ET) —
    the convention the Dice+BCE region loss expects
    (train/losses.py::REGION_LABELS).
    """
    data, _, _ = load_case_volumes(case)
    if case.seg_path is None:
        raise ValueError(f"case {case.case_id} has no _seg ground truth")
    seg = np.round(
        nifti.load(case.seg_path).get_fdata(dtype=np.float32)
    ).astype(np.int32)
    # ground-truth files ship in BraTS convention (2021 when label 4 is
    # present, else 2025); the loss wants internal labels
    if (seg == 4).any():
        seg = np.asarray(brats2021_to_internal(seg)).astype(np.int32)
    else:
        seg = np.asarray(brats2025_to_internal(seg)).astype(np.int32)
    data, mask, info = crop_to_nonzero(data)
    seg_c = seg[info.slices]
    # host z-score: the host-side patch sampler consumes the result
    data = zscore_masked_np(data, mask)
    return data.astype(np.float32), seg_c.astype(np.int32)


@dataclass
class PatchSampler:
    """Random-patch batch iterator over preprocessed cases.

    ``oversample_fg``: fraction of patches whose center is forced onto a
    foreground voxel (nnU-Net default 1/3), so sparse tumors are seen.
    """

    cases: Sequence[BratsCase]
    patch_size: Tuple[int, int, int] = (128, 128, 128)
    batch_size: int = 2
    oversample_fg: float = 1 / 3
    mirror: bool = True
    seed: int = 0
    #: optional nnU-Net-style transform set (train/augment.py)
    augment: Optional[AugmentConfig] = None
    #: draw every patch of a batch from its own random case (nnU-Net's
    #: decorrelated batches) instead of one resident case per batch.  The
    #: default keeps host I/O amortized (one 4-modality decode + preprocess
    #: per batch rather than per patch) — the right trade on hosts where
    #: loading competes with the device for CPU.
    mixed_batches: bool = False

    def __post_init__(self):
        if not self.cases:
            raise ValueError("no training cases")
        self._rng = np.random.default_rng(self.seed)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def _get_case(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if idx not in self._cache:
            # one resident case keeps host memory bounded
            self._cache.clear()
            data, seg = load_training_case(self.cases[idx])
            # precompute the foreground coordinate list once per resident
            # case (nnU-Net precomputes class locations the same way) —
            # a full-volume argwhere per forced-fg draw is a host scan
            # ~batch_size×steps times more often than needed
            fg = np.argwhere(seg > 0)
            self._cache[idx] = (data, seg, fg)
        return self._cache[idx]

    def _sample_patch(
        self, data: np.ndarray, seg: np.ndarray, fg: np.ndarray, force_fg: bool
    ):
        _, X, Y, Z = data.shape
        ps = self.patch_size
        # pad small volumes up to the patch size
        pads = [(0, max(0, p - s)) for p, s in zip(ps, (X, Y, Z))]
        if any(p[1] for p in pads):
            data = np.pad(data, [(0, 0)] + pads)
            seg = np.pad(seg, pads)
            _, X, Y, Z = data.shape
        # fg coordinates were computed on the unpadded volume; padding only
        # appends at the high end, so they remain valid patch centers
        if not force_fg:
            fg = np.empty((0, 3))
        if len(fg):
            c = fg[self._rng.integers(len(fg))]
            start = [
                int(np.clip(c[i] - ps[i] // 2, 0, (X, Y, Z)[i] - ps[i]))
                for i in range(3)
            ]
        else:
            start = [int(self._rng.integers(0, (X, Y, Z)[i] - ps[i] + 1)) for i in range(3)]
        sl = tuple(slice(s, s + p) for s, p in zip(start, ps))
        dp = data[(slice(None),) + sl]
        sp = seg[sl]
        if self.mirror:
            for ax in range(3):
                if self._rng.random() < 0.5:
                    dp = np.flip(dp, axis=ax + 1)
                    sp = np.flip(sp, axis=ax)
        return np.ascontiguousarray(dp), np.ascontiguousarray(sp)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rng.permutation(len(self.cases))
        pos = 0

        def next_case():
            nonlocal order, pos
            idx = int(order[pos % len(order)])
            pos += 1
            if pos % len(order) == 0:
                order = self._rng.permutation(len(self.cases))
            return self._get_case(idx)

        while True:
            imgs, labs = [], []
            if not self.mixed_batches:
                data, seg, fg = next_case()
            for b in range(self.batch_size):
                if self.mixed_batches:
                    data, seg, fg = next_case()
                force_fg = self._rng.random() < self.oversample_fg
                dp, sp = self._sample_patch(data, seg, fg, force_fg)
                if self.augment is not None:
                    dp, sp = augment_patch(self._rng, dp, sp, self.augment)
                imgs.append(np.moveaxis(dp, 0, -1))  # (D, H, W, C)
                labs.append(sp)
            yield {
                "image": np.stack(imgs).astype(np.float32),
                "labels": np.stack(labs).astype(np.int32),
            }
