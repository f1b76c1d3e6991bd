"""Case-level inference: preprocess -> model ensemble -> labels -> export.

Counterpart of ``braintpu/infer/engine.py``: a :class:`ModelBundle` per
architecture (its folds; BatchNorm folded, GroupNorm / InstanceNorm kept as
loaded) run in one of two modes,

* ``"sliding"`` (the default, as in the reference): nnU-Net's 128^3 /
  50 %-overlap Gaussian-blended sliding window (:mod:`.sliding_window`), the
  volume padded to the largest patch of the ensemble;
* ``"fullconv"``: one whole-volume forward per fold and mirror
  (:mod:`.fullconv`), the volume padded to a multiple of ``2**num_pool``;

and one of two ensembles,

* ``"softmax"`` (canonical): the mean of the models' sigmoid region maps,
  then the KAIST 200-voxel ET rule;
* ``"label"`` (repo parity): ``round(mean of the models' label maps)`` with
  numpy's round-half-to-even, never followed by the ET rule;

then uncrop, the output label convention and per-region volumes.

The axial families (``models.unet3d.AXIAL_UNET`` / ``AXIAL_UNET_FULL``) run
in sliding mode only (fullconv refuses them, as in the reference), with the
reference's mirror chunk of 8.

:meth:`InferenceEngine.predict_cases_batched` runs several cases of one
bucket through the fullconv ensemble at once.

Over a mesh of ranks (``mesh``, :mod:`braintpu_torch.parallel`; every rank
runs the same calls on the same cases): ``predict_cases_batched`` gives
each ``data`` rank its rows of every padded batch and gathers the label
maps (rank 0 writes the files); with ``spatial_shard`` a single case's X
axis is split over the ranks (:func:`.fullconv.fullconv_predict_spatial`).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` (with
a mesh: on the mesh's device); with no card and no CPU request it raises.
"""

from __future__ import annotations

import contextlib
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
from ..utils.device import resolve_device
from .fullconv import fullconv_predict, fullconv_predict_spatial, predict_probs_fullconv
from .sliding_window import predict_probs, region_probs_to_labels

__all__ = ["ModelBundle", "InferenceEngine", "calculate_volumes", "uncrop_labels", "resolve_device"]


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
    #: BatchNorm folded into the convs (False, the reference's default: the
    #: norms run in the forward; always False for GroupNorm / InstanceNorm)
    folded: bool = False
    name: str = ""

    @classmethod
    def from_folds(
        cls,
        cfg: UNetConfig,
        fold_params: Sequence[Dict[str, Any]],
        fold_bn: bool = True,
        name: str = "",
    ) -> "ModelBundle":
        """Inference-ready copies of each fold's parameters.

        A BatchNorm model has its norm folded into the convs (in f32) and is
        marked ``folded``, unless ``fold_bn`` is False: then its norms stay
        in the forward (eval BatchNorm with the running statistics), as the
        reference's ``fold_bn=False``.  A GroupNorm / InstanceNorm model has
        nothing to fold: its parameters stay as loaded (``folded`` False).
        Either way the conv, up-conv and seg kernels are stored at the
        compute dtype -- one rounding from the loaded leaf, the same bits as
        the reference's use-site cast -- and biases, scales, shifts and
        statistics in f32.

        ``fold_params``: port parameters (``ckpt.npz.params_from_jax`` or
        ``models.unet3d.init_params``) at any float dtype.
        """
        folded = fold_bn and cfg.norm == "batch"

        def store(t: torch.Tensor) -> torch.Tensor:
            return t.to(cfg.compute_dtype) if t.dim() >= 5 else t.float()

        params = [fold_batchnorm(p, cfg) if folded else p for p in fold_params]
        return cls(cfg, [_map_tree(store, p) for p in params], folded, name or cfg.name)

    def to(self, device: torch.device) -> "ModelBundle":
        moved = [_map_tree(lambda t: t.to(device), p) for p in self.fold_params]
        return ModelBundle(self.cfg, moved, self.folded, self.name)


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
    """Multi-model, multi-fold BraTS segmentation engine."""

    models: List[ModelBundle]
    step_size: float = 0.5  # sliding-window overlap step, in patches
    tta: bool = True
    ensemble: str = "softmax"  # "softmax" (canonical) | "label" (repo parity)
    et_min_voxels: int = 200  # 0 disables; applied only in softmax mode
    output_convention: str = "brats2025"  # "brats2025" | "brats2021" | "internal"
    #: "sliding": the 128^3 / 50 %-overlap Gaussian-blended recipe;
    #: "fullconv": the whole-volume forward (about 3x fewer FLOPs on a
    #: BraTS-size case; GroupNorm statistics over the whole volume).
    mode: str = "sliding"
    #: optional ``parallel.mesh.Mesh`` with a ``data`` axis:
    #: predict_cases_batched splits each case batch over it (case-level data
    #: parallelism, no collective on the forward path).  Single-case calls
    #: are unaffected unless ``spatial_shard`` is set.
    mesh: Optional[Any] = None
    #: with ``mesh`` and ``mode="fullconv"``: split each single case's X
    #: axis over the mesh's ``data`` axis (halo exchange, statistics summed
    #: over the slabs): per-rank activation memory and single-case latency
    #: instead of batch throughput.  X is padded up to a multiple of (mesh
    #: size x 2**num_pool) and sliced back; like fullconv's bucket padding
    #: the extra background border shifts values near the volume edge, while
    #: the sharding itself is exact (tested).
    spatial_shard: bool = False
    #: None = the card; "cpu" only when asked for (the port's own field,
    #: after the reference's)
    device: Union[None, str, torch.device] = None

    def __post_init__(self) -> None:
        if self.mode not in ("sliding", "fullconv"):
            raise ValueError(f"mode={self.mode!r}: choose 'sliding' or 'fullconv'")
        if self.ensemble not in ("softmax", "label"):
            raise ValueError(f"ensemble={self.ensemble!r}: choose 'softmax' or 'label'")
        if len({m.cfg.num_classes for m in self.models}) != 1:
            raise ValueError("ensemble models must share num_classes")
        if self.mesh is not None:
            if self.device is not None and torch.device(self.device) != self.mesh.device:
                raise ValueError(f"device {self.device} but the mesh's rank runs on "
                                 f"{self.mesh.device}")
            self.device = self.mesh.device
        # the folds go to the device once per engine (on a mesh: each rank's
        # own copy), never once per case
        self.device = resolve_device(self.device)
        self.models = [m.to(self.device) for m in self.models]

    def warmup(self, bucket_shape: Tuple[int, int, int] = (192, 192, 160),
               batch_size: int = 0) -> float:
        """Run one dummy case of ``bucket_shape`` in the engine's mode
        (first-use costs: kernel build, cuDNN plans, allocator growth).  With
        ``batch_size`` (fullconv) it runs the batch :meth:`predict_cases_batched`
        runs instead.  Returns seconds spent."""
        t0 = time.perf_counter()
        # fully nonzero, so the crop keeps the whole bucket
        dummy = np.ones((4,) + tuple(bucket_shape), np.float32)
        if batch_size > 0 and self.mode == "fullconv":
            div = max(2**m.cfg.num_pool for m in self.models)
            pre = preprocess_case(dummy, patch_size=(div,) * 3, pad_multiple=div,
                                  device=self.device)
            self._batched_fullconv(pre.data.movedim(0, -1)[None], self._batch_target(batch_size))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        else:
            self.predict_case_array(dummy)
        return time.perf_counter() - t0

    def predict_case_array(self, data_cxyz: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        """(C, X, Y, Z) float stack -> (labels in output convention, info)."""
        t0 = time.perf_counter()
        if self.mode == "fullconv":
            # every axis must divide through all pool stages of every model
            div = max(2**m.cfg.num_pool for m in self.models)
            pre = preprocess_case(data_cxyz, patch_size=(div,) * 3, pad_multiple=div,
                                  device=self.device)
        else:
            # pad to the largest patch across models so every model can tile it
            patch = tuple(max(m.cfg.patch_size[i] for m in self.models) for i in range(3))
            pre = preprocess_case(data_cxyz, patch_size=patch, device=self.device)
        info: Dict[str, Any] = {"preprocess_s": time.perf_counter() - t0}
        info["bucket_shape"] = tuple(int(s) for s in pre.data.shape[1:])
        t1 = time.perf_counter()
        per_model_probs = []
        for m in self.models:
            if self.mode == "fullconv" and self.spatial_shard and self.mesh is not None:
                probs = self._spatial_fullconv(pre.data, m)
            elif self.mode == "fullconv":
                probs = predict_probs_fullconv(m.fold_params, pre.data, m.cfg, tta=self.tta,
                                               folded=m.folded)
            else:
                probs = predict_probs(m.fold_params, pre.data, m.cfg, step_size=self.step_size,
                                      tta=self.tta, folded=m.folded)
            per_model_probs.append(probs)
        seg_internal = self._ensemble_labels(per_model_probs, pre)  # syncs: labels to host
        info["predict_s"] = time.perf_counter() - t1
        out = self._to_output_convention(seg_internal, pre)
        info["total_s"] = time.perf_counter() - t0
        info["num_models"] = len(self.models)
        info["ensemble"] = self.ensemble
        info["mode"] = self.mode
        return out, info

    def _ensemble_labels(self, per_model_probs, pre) -> np.ndarray:
        """Model-ensemble probability maps -> internal-label segmentation."""
        return self._finish_labels(self._paint_labels(per_model_probs)[pre.undo_slices])

    def _paint_labels(self, per_model_probs) -> torch.Tensor:
        """The models' probability maps -> the ensemble's uint8 label map on
        the device, at the maps' shape."""
        # label mode applies with any model count: the repo-parity recipe
        # never runs the ET rule, so a single-model label run must not either
        if self.ensemble == "label":
            segs = [region_probs_to_labels(p) for p in per_model_probs]
            # round half to even, as numpy's round
            return torch.round(sum(s.float() for s in segs) / len(segs)).to(torch.uint8)
        return region_probs_to_labels(sum(per_model_probs) / len(per_model_probs))

    def _finish_labels(self, seg: torch.Tensor) -> np.ndarray:
        """Cropped-space labels to the host, with the ET rule in softmax mode."""
        seg_internal = seg.cpu().numpy()
        if self.ensemble == "softmax" and self.et_min_voxels:
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

    def _spatial_fullconv(self, vol_cxyz: torch.Tensor, m: ModelBundle) -> torch.Tensor:
        """One model's (X, Y, Z, K) probabilities with X split over the
        mesh's ``data`` axis.  X is padded at the high end to a multiple of
        (mesh size x 2**num_pool), so every slab boundary stays on the pool
        grid, and sliced back: the contract is fullconv of the padded volume,
        as a larger bucket would be."""
        n = self.mesh.shape["data"]
        div = 2**m.cfg.num_pool
        x = vol_cxyz.movedim(0, -1)  # (X, Y, Z, C)
        X = int(x.shape[0])
        target = -(-X // (n * div)) * n * div
        if target != X:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 0, target - X))
        probs = fullconv_predict_spatial(m.fold_params, x.contiguous(), m.cfg, self.mesh,
                                         axis="data", num_mirror=8 if self.tta else 1,
                                         folded=m.folded)
        return probs[:X]

    def _batch_target(self, batch_size: int) -> int:
        """The fixed batch of :meth:`predict_cases_batched`: ``batch_size``,
        rounded up to a multiple of the mesh's ``data`` axis."""
        if self.mesh is not None:
            nd = self.mesh.shape["data"]
            return -(-batch_size // nd) * nd
        return batch_size

    def _batched_fullconv(self, vols: torch.Tensor, target: int) -> List[torch.Tensor]:
        """Every model's (B, X, Y, Z, K) probabilities for a (b, X, Y, Z, C)
        case batch padded to ``target`` rows with copies of its last case, as
        the reference pads to keep one program per bucket (here it keeps one
        batch shape, and so one set of launch shapes, per bucket).  The
        padded rows are the caller's to drop.  With a mesh, this rank's rows
        of the padded batch only (``target / data`` of them)."""
        n_pad = target - vols.shape[0]
        if n_pad > 0:
            vols = torch.cat([vols, vols[-1:].expand(n_pad, *vols.shape[1:])])
        if self.mesh is not None:
            comm = self.mesh.comm("data")
            per = target // comm.size
            vols = vols[comm.index * per:(comm.index + 1) * per]
        return [fullconv_predict(m.fold_params, vols, m.cfg, num_mirror=8 if self.tta else 1,
                                 folded=m.folded) for m in self.models]

    def predict_cases_batched(
        self, cases: List[BratsCase], output_dir: Optional[Path] = None,
        batch_size: int = 4, max_pending: Optional[int] = None,
        keep_volumes: Optional[bool] = None,
    ) -> List[Tuple[Optional[np.ndarray], Dict[str, Any]]]:
        """Multi-case segmentation on one card, in fullconv mode.

        Cases stream in through a :class:`~braintpu_torch.io.brats.CasePrefetcher`
        (decode on a host thread), are grouped by padded bucket shape and run
        through the whole-volume ensemble ``batch_size`` at a time, each
        batch padded with copies of its last case to one fixed batch shape
        (padded rows dropped).  At most ``max_pending`` preprocessed cases
        (default ``min(max(2 * batch_size, 8), 16)``) wait on the device;
        when the cap is hit the fullest bucket runs as a partial batch.
        GroupNorm statistics stay per sample, so each case's labels are its
        per-case call's (up to ``conv_stage``'s atomic summation order).

        With a mesh every rank calls this on the same cases: the batch is
        rounded up to a multiple of the mesh's ``data`` axis, each rank
        forwards its rows, the label maps are gathered, and rank 0 writes
        the files (every rank returns the results).  ``spatial_shard`` is
        refused, as in the reference.

        One batch is in flight while the host drains the previous one.  The
        reference gets that from its runtime's asynchronous dispatch; here each
        batch's forwards run on a side CUDA stream with an event recorded
        after them, and the previous batch's labels are computed on a second
        stream that waits for its event, so its label painting, copy to the
        host, ET rule, uncrop and NIfTI save overlap the next batch's
        forwards (one Python thread launches both).  On the CPU the batches
        simply run in turn.

        With ``output_dir`` the segmentations are written there and, unless
        ``keep_volumes`` is True, the returned entries are ``(None, info)``;
        without it the volumes are always returned.  Results come back in
        the order of ``cases``.
        """
        if keep_volumes is None:
            keep_volumes = output_dir is None
        if self.mode != "fullconv":
            raise ValueError("predict_cases_batched requires mode='fullconv'")
        if self.spatial_shard:
            # spatial sharding exists so one case's activations can exceed a
            # single card; batching places one whole volume per rank
            raise ValueError(
                "predict_cases_batched is case-data-parallel and incompatible "
                "with spatial_shard=True: batching places one whole volume "
                "per chip, which defeats the reason to shard spatially. Use "
                "per-case predict_case calls for spatially-sharded inference, "
                "or spatial_shard=False for batched throughput.")
        div = max(2**m.cfg.num_pool for m in self.models)
        writer = self.mesh is None or self.mesh.is_main
        if max_pending is None:
            max_pending = min(max(2 * batch_size, 8), 16)
        target = self._batch_target(batch_size)
        cuda = self.device.type == "cuda"
        compute = torch.cuda.Stream(self.device) if cuda else None
        drain = torch.cuda.Stream(self.device) if cuda else None

        def on(stream):
            return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

        results: List[Optional[Tuple[Optional[np.ndarray], Dict[str, Any]]]] = [None] * len(cases)
        pending: Dict[Tuple[int, ...], list] = {}  # bucket -> [(i, case, affine, zooms, pre)]
        n_pending = 0
        inflight: list = []  # [(chunk, per-model probabilities, done event, t0)]

        def dispatch(shape) -> None:
            nonlocal n_pending
            entries = pending.pop(shape)
            n_pending -= len(entries)
            for start in range(0, len(entries), batch_size):
                chunk = entries[start:start + batch_size]
                t0 = time.perf_counter()
                done = None
                if cuda:
                    # the batch reads what preprocess wrote on the current stream
                    compute.wait_stream(torch.cuda.current_stream(self.device))
                    for e in chunk:
                        e[4].data.record_stream(compute)
                with on(compute):
                    vols = torch.stack([e[4].data.movedim(0, -1) for e in chunk])
                    per_model = self._batched_fullconv(vols, target)
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(compute)
                inflight.append((chunk, per_model, done, t0))
                while len(inflight) > 1:
                    drain_one()

        def drain_one() -> None:
            chunk, per_model, done, t0 = inflight.pop(0)
            if done is not None:
                done.synchronize()
            device_span = time.perf_counter() - t0
            t1 = time.perf_counter()
            with on(drain):
                if done is not None:
                    drain.wait_event(done)
                if self.mesh is not None:  # every rank's rows of the padded batch
                    from ..parallel.collectives import all_gather

                    painted = all_gather(self._paint_labels(per_model), self.mesh.comm("data"))
                for bi, (i, case, affine, zooms, pre) in enumerate(chunk):
                    if self.mesh is not None:
                        seg_internal = self._finish_labels(painted[bi][pre.undo_slices])
                    else:
                        seg_internal = self._ensemble_labels([p[bi] for p in per_model], pre)
                    out = self._to_output_convention(seg_internal, pre)
                    info = {"case_id": case.case_id, "batch_seconds": device_span,
                            "batch_size": len(chunk), "volumes_cm3": self._case_volumes(out, zooms)}
                    if output_dir is not None and writer:
                        path = Path(output_dir) / f"{case.case_id}.nii.gz"
                        nifti.save(out.astype(np.uint8), path, affine=affine)
                        info["output_path"] = str(path)
                    info["ensemble_host_s"] = time.perf_counter() - t1
                    results[i] = (out if keep_volumes else None, info)
                if drain is not None:
                    drain.synchronize()  # the probabilities are freed after this

        from ..io.brats import CasePrefetcher

        for i, (case, (data, affine, zooms)) in enumerate(CasePrefetcher(cases, depth=2)):
            pre = preprocess_case(data, patch_size=(div,) * 3, pad_multiple=div,
                                  device=self.device)
            del data  # the raw decode; ``pre`` holds the cropped copy
            shape = tuple(pre.data.shape)
            pending.setdefault(shape, []).append((i, case, affine, zooms, pre))
            n_pending += 1
            if len(pending[shape]) >= batch_size:
                dispatch(shape)
            elif n_pending >= max_pending:
                dispatch(max(pending, key=lambda s: len(pending[s])))
        for shape in sorted(pending, key=lambda s: -len(pending[s])):
            dispatch(shape)
        while inflight:
            drain_one()
        return [r for r in results if r is not None]

    def predict_case(
        self,
        case: BratsCase,
        output_path: Optional[Path] = None,
        loaded: Optional[Tuple[np.ndarray, np.ndarray, Tuple[float, ...]]] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Load a case from disk, segment it, optionally save NIfTI + volumes.

        Pass ``loaded=(data, affine, zooms)`` (e.g. from
        :class:`braintpu_torch.io.brats.CasePrefetcher`) to overlap the next
        case's host-side decode with this case's device work.
        ``info["decode_route"]`` is the decoder that read the case
        (``"native"`` or ``"python"``; ``"caller"`` for arrays the caller
        decoded some other way).
        """
        if loaded is None:
            loaded = load_case_volumes(case)
        data, affine, zooms = loaded
        seg, info = self.predict_case_array(data)
        info["decode_route"] = getattr(loaded, "route", "caller")
        info["volumes_cm3"] = self._case_volumes(seg, zooms)
        info["case_id"] = case.case_id
        if output_path is not None:
            nifti.save(seg.astype(np.uint8), output_path, affine=affine)
            info["output_path"] = str(output_path)
        return seg, info
