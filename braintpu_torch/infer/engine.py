"""Case-level inference: preprocess -> fullconv ensemble -> labels -> export.

Counterpart of ``braintpu/infer/engine.py`` in fullconv mode: a
:class:`ModelBundle` per architecture (its folds; BatchNorm folded,
GroupNorm / InstanceNorm kept as loaded), the softmax-level ensemble (mean of the models' sigmoid region maps, then the
KAIST 200-voxel ET rule), uncrop, the output label convention and
per-region volumes.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no CPU request it raises.  Sliding-window mode, multi-case
batching, meshes, spatial sharding and the label-level ensemble are not
ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..io import nifti
from ..io.brats import BratsCase, load_case_volumes
from ..labels.convert import internal_to_brats2021, internal_to_brats2025
from ..labels.postprocess import et_min_size_postprocess
from ..models.unet3d import UNetConfig, fold_batchnorm
from ..pre.preprocess import preprocess_case
from .fullconv import predict_probs_fullconv, region_probs_to_labels

__all__ = ["ModelBundle", "InferenceEngine", "calculate_volumes", "uncrop_labels", "resolve_device"]


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: braintpu_torch runs on the card unless device='cpu' is passed")
    return dev


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


@dataclass
class ModelBundle:
    """One architecture + its per-fold weights, inference-ready."""

    cfg: UNetConfig
    fold_params: List[Dict[str, Any]]  # see from_folds
    name: str = ""
    #: BatchNorm folded into the convs (False for GroupNorm / InstanceNorm)
    folded: bool = True

    @classmethod
    def from_folds(
        cls, cfg: UNetConfig, fold_params: Sequence[Dict[str, Any]], name: str = ""
    ) -> "ModelBundle":
        """Inference-ready copies of each fold's parameters.

        A BatchNorm model has its norm folded into the convs (in f32) and is
        marked ``folded``.  A GroupNorm / InstanceNorm model has nothing to
        fold: its parameters stay as loaded (``folded`` False).  Either way
        the conv, up-conv and seg kernels are stored at the compute dtype --
        one rounding from the loaded leaf, the same bits as the reference's
        use-site cast -- and biases, scales and shifts in f32.

        ``fold_params``: port parameters (``ckpt.npz.params_from_jax`` or
        ``models.unet3d.init_params``) at any float dtype.
        """
        folded = cfg.norm == "batch"

        def store(t: torch.Tensor) -> torch.Tensor:
            return t.to(cfg.compute_dtype) if t.dim() >= 5 else t.float()

        params = [fold_batchnorm(p, cfg) if folded else p for p in fold_params]
        return cls(cfg, [_map_tree(store, p) for p in params], name or cfg.name, folded)

    def to(self, device: torch.device) -> "ModelBundle":
        moved = [_map_tree(lambda t: t.to(device), p) for p in self.fold_params]
        return ModelBundle(self.cfg, moved, self.name, self.folded)


def uncrop_labels(seg_cropped: np.ndarray, crop) -> np.ndarray:
    """Place cropped-space labels back into the original volume extent."""
    out = np.zeros(crop.original_shape, dtype=seg_cropped.dtype)
    out[crop.slices] = seg_cropped
    return out


def calculate_volumes(
    seg: np.ndarray,
    voxel_volume_cm3: float,
    et_label: int = 3,
    convention: str = "brats",
) -> Dict[str, float]:
    """NCR/ED/ET/TC/WT volumes in cm^3 from a label map.

    ``convention="internal"`` handles nnU-Net internal space, where 1=ED and
    2=NCR are swapped relative to BraTS.
    """
    ncr_label, ed_label = (2, 1) if convention == "internal" else (1, 2)
    ncr = float((seg == ncr_label).sum())
    ed = float((seg == ed_label).sum())
    et = float((seg == et_label).sum())
    return {
        "NCR": ncr * voxel_volume_cm3,
        "ED": ed * voxel_volume_cm3,
        "ET": et * voxel_volume_cm3,
        "TC": (ncr + et) * voxel_volume_cm3,
        "WT": (ncr + ed + et) * voxel_volume_cm3,
    }


@dataclass
class InferenceEngine:
    """Multi-model, multi-fold BraTS segmentation engine (fullconv mode)."""

    models: List[ModelBundle]
    tta: bool = True
    et_min_voxels: int = 200  # 0 disables
    output_convention: str = "brats2025"  # "brats2025" | "brats2021" | "internal"
    mode: str = "fullconv"
    #: None = the card; "cpu" only when asked for.
    device: Union[None, str, torch.device] = None

    def __post_init__(self) -> None:
        if self.mode != "fullconv":
            raise NotImplementedError(f"mode={self.mode!r} is not ported yet (fullconv only)")
        if len({m.cfg.num_classes for m in self.models}) != 1:
            raise ValueError("ensemble models must share num_classes")
        self.device = resolve_device(self.device)
        self.models = [m.to(self.device) for m in self.models]

    def warmup(self, bucket_shape: Tuple[int, int, int] = (192, 192, 160)) -> float:
        """Run one dummy case of ``bucket_shape`` (first-use costs: kernel
        build, cuDNN plans, allocator growth).  Returns seconds spent."""
        t0 = time.perf_counter()
        self.predict_case_array(np.ones((4,) + tuple(bucket_shape), np.float32))
        return time.perf_counter() - t0

    def predict_case_array(self, data_cxyz: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        """(C, X, Y, Z) float stack -> (labels in output convention, info)."""
        t0 = time.perf_counter()
        div = max(2**m.cfg.num_pool for m in self.models)
        pre = preprocess_case(data_cxyz, patch_size=(div,) * 3, pad_multiple=div,
                              device=self.device)
        info: Dict[str, Any] = {"preprocess_s": time.perf_counter() - t0}
        info["bucket_shape"] = tuple(int(s) for s in pre.data.shape[1:])
        t1 = time.perf_counter()
        per_model_probs = [
            predict_probs_fullconv(m.fold_params, pre.data, m.cfg, tta=self.tta,
                                   folded=m.folded)
            for m in self.models
        ]
        seg_internal = self._ensemble_labels(per_model_probs, pre)  # syncs: labels to host
        info["predict_s"] = time.perf_counter() - t1
        out = self._to_output_convention(seg_internal, pre)
        info["total_s"] = time.perf_counter() - t0
        info["num_models"] = len(self.models)
        return out, info

    def _ensemble_labels(self, per_model_probs, pre) -> np.ndarray:
        """Mean of the models' probability maps -> internal-label segmentation
        (the softmax-level ensemble), then the ET rule."""
        mean_probs = sum(per_model_probs) / len(per_model_probs)
        seg_internal = region_probs_to_labels(mean_probs)[pre.undo_slices].cpu().numpy()
        if self.et_min_voxels:
            seg_internal = et_min_size_postprocess(
                seg_internal, et_label=3, replace_with=2, min_voxels=self.et_min_voxels)
        return seg_internal

    def _to_output_convention(self, seg_internal: np.ndarray, pre) -> np.ndarray:
        full = uncrop_labels(np.asarray(seg_internal), pre.crop)
        if self.output_convention == "brats2025":
            return internal_to_brats2025(full)
        if self.output_convention == "brats2021":
            return internal_to_brats2021(full)
        return full

    def _case_volumes(self, seg, zooms) -> dict:
        """Per-region volumes (cm^3) of an output-convention segmentation."""
        voxel_cm3 = float(np.prod(zooms[:3])) / 1000.0
        et_label = 4 if self.output_convention == "brats2021" else 3
        conv = "internal" if self.output_convention == "internal" else "brats"
        return calculate_volumes(seg, voxel_cm3, et_label, conv)

    def predict_case(
        self,
        case: BratsCase,
        output_path: Optional[Path] = None,
        loaded: Optional[Tuple[np.ndarray, np.ndarray, Tuple[float, ...]]] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Load a case from disk, segment it, optionally save NIfTI + volumes."""
        data, affine, zooms = loaded if loaded is not None else load_case_volumes(case)
        seg, info = self.predict_case_array(data)
        info["volumes_cm3"] = self._case_volumes(seg, zooms)
        info["case_id"] = case.case_id
        if output_path is not None:
            nifti.save(seg.astype(np.uint8), output_path, affine=affine)
            info["output_path"] = str(output_path)
        return seg, info
