"""Rank bodies that run each sharded path beside its unsharded counterpart.

``launch.spawn(run, n, args=(specs,))`` runs the named scenarios in order
inside one set of ranks (so one start-up serves many checks) and returns,
from every rank, ``{name: result}``: numpy arrays of the sharded and the
unsharded computation, and the rank's kernel launches and collective
traffic in the sharded part.  The CPU tests hold them against the
reference package; the chip smoke runs them at full width on the card.
Inputs are numpy arrays and configs (pickled to the ranks); parameters are
drawn in each rank from ``init_params`` seeds, so every rank holds the same
weights.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.unet3d import UNetConfig, apply_unet, init_params
from . import collectives
from .launch import rank_device
from .mesh import make_mesh

__all__ = ["SCENARIOS", "kernel_counts", "run"]


def kernel_counts() -> Dict[str, int]:
    from ..ops.conv3d import conv3d_tap_merged
    from ..ops.stage import conv_stage
    from ..ops.upconv import upconv2x

    return {"conv3d_tap_merged": conv3d_tap_merged.launches, "conv_stage": conv_stage.launches,
            "upconv2x": upconv2x.launches}


def _reset_counts() -> None:
    from ..ops.conv3d import conv3d_tap_merged
    from ..ops.stage import conv_stage
    from ..ops.upconv import upconv2x

    for fn in (conv3d_tap_merged, conv_stage, upconv2x):
        fn.launches = 0
    collectives.reset_traffic()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Measured:
    """Launches, collective traffic, seconds and peak memory of a block."""

    def __enter__(self):
        self.dev = rank_device()
        _sync(self.dev)
        _reset_counts()
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.launches = kernel_counts()
        self.traffic = {k: dict(v) for k, v in collectives.TRAFFIC.items()}
        self.peak = (torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda"
                     else None)
        return False

    def report(self) -> Dict[str, Any]:
        return {"seconds": self.seconds, "launches": self.launches, "traffic": self.traffic,
                "max_memory_allocated_bytes": self.peak}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _bundle_folds(cfg: UNetConfig, seeds: Sequence[int], fold_bn: bool = False):
    """Inference folds on this rank's device (``infer.engine.ModelBundle``'s
    storage: kernels at the compute dtype) and whether they are folded."""
    from ..infer.engine import ModelBundle

    b = ModelBundle.from_folds(cfg, [init_params(cfg, s) for s in seeds], fold_bn=fold_bn)
    b = b.to(rank_device())
    return b.fold_params, b.folded


def _route(mesh, t: torch.Tensor) -> str:
    return collectives.route(mesh.comm("data"), t)


def fold(cfg: UNetConfig, seeds: Sequence[int], x: np.ndarray, pad_to: int) -> Dict[str, Any]:
    """Fold-parallel forward over every rank (``data = world``), the folds
    padded to ``pad_to``, against the serial fold mean."""
    from .distributed import make_fold_parallel_forward, pad_folds_for_axis

    mesh = make_mesh()
    dev = rank_device()
    folds = [_to(init_params(cfg, s), dev) for s in seeds]
    xs = torch.from_numpy(x).to(dev)
    padded, w = pad_folds_for_axis(folds, len(folds), pad_to)
    fwd = make_fold_parallel_forward(cfg, mesh, num_folds=len(folds))
    with _Measured() as m:
        got = fwd(padded, w, xs)
    with torch.inference_mode():
        serial = sum(torch.sigmoid(apply_unet(p, xs, cfg)) for p in folds) / len(folds)
    return {"sharded": _np(got), "serial": _np(serial), "padded": len(padded),
            "weights": w.numpy(), **m.report()}


def mirror(cfg: UNetConfig, seeds: Sequence[int], vol: np.ndarray) -> Dict[str, Any]:
    """Mirror-sharded fullconv over every rank against the unsharded one."""
    from ..infer.fullconv import fullconv_predict, fullconv_predict_sharded

    mesh = make_mesh()
    folds, folded = _bundle_folds(cfg, seeds)
    v = torch.from_numpy(vol).to(rank_device())
    with _Measured() as m:
        got = fullconv_predict_sharded(folds, v, cfg, mesh, folded=folded)
    plain = fullconv_predict(folds, v, cfg, num_mirror=8, folded=folded)
    return {"sharded": _np(got), "plain": _np(plain), "route": _route(mesh, v), **m.report()}


def spatial(cfg: UNetConfig, seeds: Sequence[int], vol: np.ndarray, num_mirror: int = 1,
            fold_bn: bool = False) -> Dict[str, Any]:
    """X-sharded fullconv over every rank against the unsharded one."""
    from ..infer.fullconv import fullconv_predict, fullconv_predict_spatial

    mesh = make_mesh()
    folds, folded = _bundle_folds(cfg, seeds, fold_bn)
    v = torch.from_numpy(vol).to(rank_device())
    with _Measured() as m:
        got = fullconv_predict_spatial(folds, v, cfg, mesh, num_mirror=num_mirror,
                                       folded=folded)
    with _Measured() as p:
        plain = fullconv_predict(folds, v, cfg, num_mirror=num_mirror, folded=folded)
    return {"sharded": _np(got), "plain": _np(plain), "route": _route(mesh, v), **m.report(),
            "plain_report": p.report()}


def engine_spatial(cfg: UNetConfig, seeds: Sequence[int], data: np.ndarray) -> Dict[str, Any]:
    """The engine's padded X-sharded path (no TTA, no ET rule) against the
    unsharded forward of the same padded volume, and its labels."""
    from ..infer.engine import InferenceEngine, ModelBundle
    from ..infer.fullconv import fullconv_predict
    from ..pre.preprocess import preprocess_case

    mesh = make_mesh()
    n = mesh.shape["data"]
    bundle = ModelBundle.from_folds(cfg, [init_params(cfg, s) for s in seeds])
    eng = InferenceEngine(models=[bundle], mode="fullconv", tta=False, et_min_voxels=0,
                          mesh=mesh, spatial_shard=True)
    b = eng.models[0]
    div = 2**cfg.num_pool
    pre = preprocess_case(data, patch_size=(div,) * 3, pad_multiple=div, device=eng.device)
    X = int(pre.data.shape[1])
    target = -(-X // (n * div)) * n * div
    xpad = torch.nn.functional.pad(pre.data.movedim(0, -1), (0, 0, 0, 0, 0, 0, 0, target - X))
    ref = fullconv_predict(b.fold_params, xpad.contiguous(), cfg, num_mirror=1,
                           folded=b.folded)[:X]
    got = eng._spatial_fullconv(pre.data, b)
    seg, _ = eng.predict_case_array(data)
    return {"sharded": _np(got), "plain": _np(ref), "X": X, "target": target, "seg": seg}


def batched(cfg: UNetConfig, seeds: Sequence[int], root: str, out: str,
            batch_size: int = 2) -> Dict[str, Any]:
    """``predict_cases_batched`` over a mesh of every rank (rank 0 writes
    ``out``) against per-case calls of an engine without a mesh."""
    from ..infer.engine import InferenceEngine, ModelBundle
    from ..io.brats import find_cases

    mesh = make_mesh()
    bundle = ModelBundle.from_folds(cfg, [init_params(cfg, s) for s in seeds])
    cases = find_cases(root)
    kw = dict(models=[bundle], mode="fullconv", tta=False, et_min_voxels=0)
    eng = InferenceEngine(mesh=mesh, **kw)
    with _Measured() as m:
        res = eng.predict_cases_batched(cases, output_dir=Path(out), batch_size=batch_size,
                                        keep_volumes=True)
    single = InferenceEngine(device=rank_device(), **kw)
    per_case = [single.predict_case(c)[0] for c in cases]
    return {"case_ids": [c.case_id for c in cases], "segs": [s for s, _ in res],
            "infos": [i for _, i in res], "per_case": per_case,
            "target": eng._batch_target(batch_size), **m.report()}


def _flat(tree, prefix="") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: _np(tree)}


def synth_batches(n: int, shape: Tuple[int, ...], seed: int) -> List[Dict[str, np.ndarray]]:
    """``n`` random training batches of ``shape`` = (N, D, H, W) from ``seed``."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal(tuple(shape) + (4,), dtype=np.float32),
             "labels": rng.integers(0, 4, tuple(shape)).astype(np.int32)} for _ in range(n)]


def train(cfg: UNetConfig, seed: int, batches: Sequence[Dict[str, np.ndarray]], data: int,
          model: int, lr: float = 1e-3, single: bool = True, params_out: bool = True,
          timed_from: int = 0) -> Dict[str, Any]:
    """``len(batches)`` sharded steps on a ``data x model`` mesh (every rank
    the same global batches), and the single-process steps on the same
    batches: losses, gradient norms, the whole parameters after them
    (``params_out``).  ``batches`` may be ``("synth", n, shape, seed)``
    (:func:`synth_batches`, drawn in the rank).  Steps from ``timed_from``
    on are timed."""
    from ..train.trainer import TrainConfig, create_train_state, train_step
    from .distributed import make_sharded_train_step, shard_train_state

    if isinstance(batches, tuple) and batches and batches[0] == "synth":
        batches = synth_batches(*batches[1:])
    mesh = make_mesh(data=data, model=model)
    tc = TrainConfig(base_lr=lr, max_steps=100)
    dev = rank_device()
    params = init_params(cfg, seed)
    state, layout = shard_train_state(create_train_state(params, tc, device=dev), cfg, mesh)
    step = make_sharded_train_step(mesh, cfg, tc, layout)
    metrics = []
    for b in batches[:timed_from]:
        state, met = step(state, b)
        metrics.append({k: float(v) for k, v in met.items()})
    with _Measured() as m:
        for b in batches[timed_from:]:
            state, met = step(state, b)
            metrics.append({k: float(v) for k, v in met.items()})
    out = {"sharded": metrics, "mesh": dict(mesh.shape), **m.report(),
           "seconds_per_step": m.seconds / max(len(batches) - timed_from, 1)}
    if params_out:
        out["params"] = _flat(step.gather_state(state).params)
    if single:
        s1 = create_train_state(params, tc, device=dev)
        ref = []
        for b in batches:
            s1, met = train_step(s1, b, cfg, tc)
            ref.append({k: float(v) for k, v in met.items()})
        out["single"] = ref
        if params_out:
            out["single_params"] = _flat(s1.params)
    return out


def patch_runner(cfg: UNetConfig, seeds: Sequence[int], vols: Sequence[np.ndarray],
                 batch_size: int) -> Dict[str, Any]:
    """``DataParallelPatchRunner`` over every rank against the unsharded
    sliding window (no TTA) of each volume."""
    from ..infer.sliding_window import predict_probs
    from .distributed import DataParallelPatchRunner

    mesh = make_mesh()
    dev = rank_device()
    folds = [_to(init_params(cfg, s), dev) for s in seeds]
    runner = DataParallelPatchRunner(folds, cfg, mesh, batch_size=batch_size)
    with _Measured() as m:
        got = runner.run(vols)
    with torch.inference_mode():
        plain = [_np(predict_probs(runner.params, torch.from_numpy(v).to(dev), cfg, tta=False))
                 for v in vols]
    return {"sharded": got, "plain": plain, **m.report()}


def _engine(argv: Sequence[str], mesh=None):
    """``cli load_engine`` of a ``segment`` command line (its prints on rank 0 only)."""
    import contextlib
    import io

    from ..cli import build_parser, load_engine

    quiet = (contextlib.nullcontext() if mesh is None or mesh.is_main
             else contextlib.redirect_stdout(io.StringIO()))
    with quiet:
        return load_engine(build_parser().parse_args(["segment", *argv]), mesh=mesh)


def _case_volume(eng, case_dir: str):
    from ..io.brats import find_cases, load_case_volumes
    from ..pre.preprocess import preprocess_case

    div = max(2**m.cfg.num_pool for m in eng.models)
    data = load_case_volumes(find_cases(case_dir)[0])[0]
    return preprocess_case(data, patch_size=(div,) * 3, pad_multiple=div, device=eng.device)


def two_model_case(argv: Sequence[str], case_dir: str, paths: Sequence[str] = ("mirror",),
                   return_probs: bool = True, diffs: Sequence[Tuple[str, str]] = ()
                   ) -> Dict[str, Any]:
    """The engine of ``segment argv`` (on a mesh of every rank) on one case's
    preprocessed volume, by path: ``plain`` (the unsharded fullconv the
    engine runs), ``mirror`` (:func:`fullconv_predict_sharded` per model),
    ``spatial`` (:func:`fullconv_predict_spatial` per model) and ``f32``
    (the unsharded forward in f32 compute with the same weights: the exact
    function both bf16 paths approximate); ``"plain#2"`` runs a path again.
    X is padded first to a multiple of (ranks x 2**num_pool), as the
    engine's X-sharded path pads it, so every path sees the same volume.  Each path reports the ensemble's internal labels, its
    launches, traffic, seconds and peak memory, and (rank 0,
    ``return_probs``) each model's probabilities; ``diffs`` names pairs of
    paths whose largest probability difference per model is reported (on
    the device, under ``"max_abs"``, and per X plane under
    ``"max_abs_by_plane"``)."""
    import dataclasses

    from ..infer.engine import _map_tree
    from ..infer.fullconv import (fullconv_predict, fullconv_predict_sharded,
                                  fullconv_predict_spatial)

    mesh = make_mesh()
    eng = _engine(argv, mesh)
    pre = _case_volume(eng, case_dir)
    vol = pre.data.movedim(0, -1)
    X = int(vol.shape[0])
    grid = mesh.shape["data"] * max(2**b.cfg.num_pool for b in eng.models)
    vol = torch.nn.functional.pad(vol, (0, 0, 0, 0, 0, 0, 0, -(-X // grid) * grid - X))
    vol = vol.contiguous()
    mirrors = 8 if eng.tta else 1
    out: Dict[str, Any] = {"bucket": tuple(int(s) for s in vol.shape[:3]),
                           "route": _route(mesh, vol), "max_abs": {}, "max_abs_by_plane": {}}
    kept = {k: None for pair in diffs for k in pair}
    for key in paths:
        path = key.split("#")[0]  # "plain#2": a second run of the same path
        with _Measured() as m:
            if path == "plain":
                probs = [fullconv_predict(b.fold_params, vol, b.cfg, num_mirror=mirrors,
                                          folded=b.folded) for b in eng.models]
            elif path == "mirror":
                probs = [fullconv_predict_sharded(b.fold_params, vol, b.cfg, mesh,
                                                  folded=b.folded) for b in eng.models]
            elif path == "spatial":
                probs = [fullconv_predict_spatial(b.fold_params, vol, b.cfg, mesh,
                                                  num_mirror=mirrors, folded=b.folded)
                         for b in eng.models]
            elif path == "f32":
                probs = [fullconv_predict(_map_tree(lambda t: t.float(), b.fold_params),
                                          vol.float(),
                                          dataclasses.replace(b.cfg, compute_dtype=torch.float32),
                                          num_mirror=mirrors, folded=b.folded)
                         for b in eng.models]
            else:
                raise ValueError(f"unknown path {path!r}")
            labels = eng._ensemble_labels([p[:X] for p in probs], pre)
        out[key] = {"labels": labels, **m.report()}
        if return_probs and mesh.is_main:
            out[key]["probs"] = [_np(p[:X]) for p in probs]
        if key in kept:
            kept[key] = [p[:X] for p in probs]
        del probs
    for a, b in diffs:
        planes = [(pa.float() - pb.float()).abs().amax(dim=(1, 2, 3))
                  for pa, pb in zip(kept[a], kept[b])]
        out["max_abs"][f"{a} vs {b}"] = [float(p.max()) for p in planes]
        out["max_abs_by_plane"][f"{a} vs {b}"] = [p.cpu().tolist() for p in planes]
    return out


def segment(argv: Sequence[str], out: str) -> Dict[str, Any]:
    """One rank of ``segment argv --dp-devices <world>`` (the CLI's rank
    body, ``cli._segment_rank``), writing into ``out/rank<r>`` so that the
    caller sees which ranks wrote; then rank 0 runs the same command
    without a mesh, case by case, into ``out/unsharded`` and reports each
    case's label agreement between the two files."""
    import copy
    import os

    from ..cli import _segment, _segment_rank, build_parser
    from ..io import nifti
    from ..io.brats import find_cases

    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    args = build_parser().parse_args(["segment", *argv, "--dp-devices", str(world),
                                      "--output", os.path.join(out, f"rank{rank}")])
    cases = find_cases(args.input)
    use_batched = args.batch_cases > 0 and len(cases) > 1  # as cmd_segment decides
    with _Measured() as m:
        _segment_rank(args, use_batched)
    res = {"written": sorted(os.listdir(args.output)), "batched": use_batched, **m.report()}
    if rank == 0:
        ref = copy.copy(args)
        ref.dp_devices, ref.spatial_shard, ref.batch_cases = 1, False, 0
        ref.output = os.path.join(out, "unsharded")
        t0 = time.perf_counter()
        _segment(ref, cases, False)
        res["unsharded_s"] = time.perf_counter() - t0
        load = lambda d, c: np.asarray(nifti.load(os.path.join(d, f"{c}.nii.gz")).dataobj)
        res["label_agreement"] = {
            c.case_id: float((load(args.output, c.case_id) == load(ref.output, c.case_id)).mean())
            for c in cases}
    return res


def patch_runner_case(argv: Sequence[str], case_dir: str, batch_size: int) -> Dict[str, Any]:
    """``DataParallelPatchRunner`` on one case's preprocessed volume with the
    first model of ``segment argv`` (sliding patches, no mirrors) against the
    unsharded sliding window of the same folds."""
    from ..infer.fullconv import region_probs_to_labels
    from ..infer.sliding_window import predict_probs
    from .distributed import DataParallelPatchRunner

    from ..io.brats import find_cases, load_case_volumes
    from ..pre.preprocess import preprocess_case

    mesh = make_mesh()
    eng = _engine(argv, mesh)
    b = eng.models[0]
    data = load_case_volumes(find_cases(case_dir)[0])[0]
    pre = preprocess_case(data, patch_size=b.cfg.patch_size, device=eng.device)
    runner = DataParallelPatchRunner(b.fold_params, b.cfg, mesh, batch_size=batch_size,
                                     folded=b.folded)
    vol = pre.data.cpu().numpy()
    with _Measured() as m:
        got = runner.run([vol])[0]
    with torch.inference_mode():
        plain = predict_probs(b.fold_params, pre.data, b.cfg, tta=False, folded=b.folded)
    got_t = torch.from_numpy(got)
    agree = float((region_probs_to_labels(got_t)
                   == region_probs_to_labels(plain.float().cpu())).float().mean())
    return {"shape": tuple(int(s) for s in pre.data.shape[1:]), "patch": tuple(b.cfg.patch_size),
            "max_abs_diff": float((got_t - plain.float().cpu()).abs().max()),
            "label_agreement": agree, **m.report()}


def collective_times(plane: Sequence[int], stats: Sequence[int], iters: int = 10
                     ) -> Dict[str, Any]:
    """Milliseconds per call of one halo exchange of a (N, L, H, W, C) bf16
    slab (``plane`` = its shape) and of one all-reduce of (2, N, C) f32
    statistics, over every rank, each call synchronised."""
    from .collectives import all_reduce_stat, halo_exchange

    mesh = make_mesh()
    comm = mesh.comm("data")
    dev = rank_device()
    x = torch.zeros(tuple(plane), dtype=torch.bfloat16, device=dev)
    st = torch.zeros((2,) + tuple(stats), dtype=torch.float32, device=dev)
    out = {"route": collectives.route(comm, x)}
    for name, fn in (("halo", lambda: halo_exchange(x, comm, dim=1)),
                     ("stats", lambda: all_reduce_stat(st, comm))):
        fn()
        _sync(dev)
        collectives.reset_traffic()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            _sync(dev)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3 / iters,
                     "bytes_per_call": collectives.TRAFFIC[name]["bytes"] // iters}
    return out


def _to(tree, device):
    from ..infer.engine import _map_tree

    return _map_tree(lambda t: t.to(device), tree)


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "fold": fold, "mirror": mirror, "spatial": spatial, "engine_spatial": engine_spatial,
    "batched": batched, "train": train, "patch_runner": patch_runner,
    "two_model_case": two_model_case, "patch_runner_case": patch_runner_case,
    "segment": segment, "collective_times": collective_times,
}


def run(specs: Sequence[Tuple[str, str, Dict[str, Any]]], launch_keys: bool = False
        ) -> Dict[str, Any]:
    """Rank body: ``specs`` = ``[(label, scenario, kwargs), ...]`` run in
    order; returns ``{label: result}``, and with ``launch_keys`` also
    ``"launch_keys"``: every kernel's distinct launch keys over all the
    scenarios (``ops._build.launch_keys``), so the caller can hold each
    kernel against its plain version at the shapes these paths gave it."""
    from ..ops import _build

    torch.backends.cudnn.allow_tf32 = False  # f32 convs compare at f32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    if launch_keys:
        _build.launch_keys = {}
    out = {label: SCENARIOS[name](**kw) for label, name, kw in specs}
    if launch_keys:
        out["launch_keys"] = {k: sorted(v, key=repr) for k, v in _build.launch_keys.items()}
        _build.launch_keys = None
    return out
