"""Entry points: a single-device forward check and a multi-rank dry run.

Counterpart of the reference's root ``__graft_entry__.py``:

* :func:`entry` returns ``(forward, (params, x))``: full-width MODEL1_BN,
  BatchNorm folded, on a 1 x 128^3 x 4 bf16 input, on the card unless
  ``device="cpu"``;
* :func:`dryrun_multichip` runs every parallel path once on ``n`` ranks
  (``parallel.launch.spawn``): the DP x TP train step (``model=2`` at
  ``n >= 4``), the fold-parallel forward, mirror sharding, spatial sharding
  checked against the unsharded forward, the patch runner, and the batched
  engine over two cases written to a temporary directory; it prints the
  reference's summary line.  On the card the ranks take a card each with
  ``nccl`` when there are enough, else share ``cuda:0`` with ``gloo``;
  ``device="cpu"`` runs ``gloo`` ranks on the CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device: Union[None, str, torch.device] = None):
    """``(fn, example_args)`` for a single-device forward check."""
    from .infer.engine import ModelBundle
    from .models.unet3d import MODEL1_BN, apply_unet, init_params
    from .utils.device import resolve_device

    cfg = MODEL1_BN
    dev = resolve_device(device)
    # folded and stored at the compute dtype, as the engine holds it
    params = ModelBundle.from_folds(cfg, [init_params(cfg, 0)]).to(dev).fold_params[0]
    x = torch.zeros((1, 128, 128, 128, cfg.in_channels), dtype=torch.bfloat16, device=dev)

    def forward(params, x):
        with torch.inference_mode():
            return apply_unet(params, x, cfg, folded=True)

    return forward, (params, x)


def _dryrun_rank(n_devices: int, case_root: str) -> Dict[str, Any]:
    """Rank body of :func:`dryrun_multichip`."""
    from .infer.engine import InferenceEngine, ModelBundle
    from .infer.fullconv import fullconv_predict, fullconv_predict_sharded
    from .infer.fullconv import fullconv_predict_spatial
    from .io.brats import find_cases
    from .models.unet3d import UNetConfig, init_params
    from .parallel import (DataParallelPatchRunner, make_fold_parallel_forward, make_mesh,
                           make_sharded_train_step, pad_folds_for_axis, shard_train_state)
    from .parallel import collectives
    from .parallel.launch import rank_device
    from .parallel.scenarios import _to, kernel_counts
    from .train.trainer import TrainConfig, create_train_state

    torch.backends.cudnn.allow_tf32 = False  # the spatial check compares f32 at 2e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    model = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    mesh = make_mesh(data=n_devices // model, model=model)

    # tiny-but-real topology: wide enough (64 channels) that TP shards
    cfg = UNetConfig(in_channels=4, num_classes=3, base_features=8, max_features=64,
                     num_pool=2, conv_per_stage=2, norm="batch", patch_size=(16, 16, 16),
                     compute_dtype=torch.float32)
    tc = TrainConfig(base_lr=1e-3, max_steps=100)
    state, layout = shard_train_state(create_train_state(init_params(cfg, 0), tc, device=dev),
                                      cfg, mesh)
    step_fn = make_sharded_train_step(mesh, cfg, tc, layout)
    batch_n = mesh.shape["data"]
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(batch_n, 16, 16, 16, 4)).astype(np.float32),
             "labels": rng.integers(0, 4, (batch_n, 16, 16, 16)).astype(np.int32)}
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # inference-side collective path: the fold-sharded ensemble
    icfg = UNetConfig(in_channels=4, num_classes=3, base_features=8, max_features=64,
                      num_pool=2, norm="instance", patch_size=(16, 16, 16),
                      compute_dtype=torch.float32)
    folds = [_to(init_params(icfg, i), dev) for i in range(5)]
    padded, w = pad_folds_for_axis(folds, 5, mesh.shape["data"])
    fwd = make_fold_parallel_forward(icfg, mesh, num_folds=5)
    probs = fwd(padded, w, torch.from_numpy(batch["image"]).to(dev))
    if not torch.isfinite(probs).all():
        raise AssertionError("fold-parallel probabilities not finite")

    # mirror-TTA-sharded whole-volume ensemble
    mdiv = max(d for d in (1, 2, 4, 8) if n_devices % d == 0 and 8 % d == 0)
    mmesh = make_mesh(data=mdiv)
    vol = torch.from_numpy(rng.normal(size=(16, 16, 16, 4)).astype(np.float32)).to(dev)
    if mmesh.member:
        fprobs = fullconv_predict_sharded(folds, vol, icfg, mmesh)
        if not torch.isfinite(fprobs).all():
            raise AssertionError("mirror-sharded probabilities not finite")

    # spatially-sharded whole-volume forward against the unsharded one
    ns = mesh.shape["data"]
    svol = torch.from_numpy(rng.normal(size=(4 * ns, 16, 16, 4)).astype(np.float32)).to(dev)
    collectives.reset_traffic()
    sprobs = fullconv_predict_spatial(folds, svol, icfg, mesh, num_mirror=1)
    spatial_traffic = {k: dict(v) for k, v in collectives.TRAFFIC.items()}
    sref = fullconv_predict(folds, svol, icfg, num_mirror=1)
    np.testing.assert_allclose(sprobs.cpu().numpy(), sref.cpu().numpy(), atol=2e-5)

    # multi-case throughput runner: data-split patch batches across cases
    runner = DataParallelPatchRunner(folds, icfg, mesh, batch_size=mesh.shape["data"])
    vols = [rng.normal(size=(4, 24, 24, 24)).astype(np.float32) for _ in range(2)]
    case_probs = runner.run(vols)
    if len(case_probs) != 2 or not all(np.isfinite(p).all() for p in case_probs):
        raise AssertionError("patch runner")

    # engine-level batched multi-case inference over the mesh
    cases = find_cases(case_root)
    if len(cases) != 2:
        raise AssertionError(f"{len(cases)} cases under {case_root}")
    engine = InferenceEngine(
        models=[ModelBundle.from_folds(icfg, [init_params(icfg, 9)], fold_bn=False)],
        tta=False, mode="fullconv", et_min_voxels=0, mesh=mesh)
    got = engine.predict_cases_batched(cases, batch_size=2)
    if len(got) != 2 or not all(np.isfinite(seg).all() for seg, _ in got):
        raise AssertionError("batched engine")
    line = (f"dryrun_multichip OK: mesh={dict(mesh.shape)} loss={loss:.4f} "
            f"step={int(metrics['step'])} fold_psum_probs={tuple(probs.shape)} "
            f"fullconv_mirror_shards={mdiv} "
            f"spatial_shards={ns} "
            f"dp_patch_runner_cases={len(case_probs)} "
            f"batched_engine_cases={len(got)}")
    return {"line": line, "launches": kernel_counts(), "spatial_traffic": spatial_traffic,
            "route": collectives.route(mesh.comm("data"), svol), "device": str(dev)}


def _write_cases(root: str, rng: np.random.Generator) -> None:
    from .io import nifti

    aff = np.diag([1.0, 1.0, 1.0, 1.0])
    for cid in ("BraTS-GLI-09001-000", "BraTS-GLI-09002-000"):
        cdir = os.path.join(root, cid)
        os.makedirs(cdir)
        for mod in ("t1", "t1ce", "t2", "flair"):
            vol = np.abs(rng.normal(300, 60, (24, 24, 24))).astype(np.float32)
            nifti.save(vol, os.path.join(cdir, f"{cid}_{mod}.nii.gz"), affine=aff)


def dryrun_multichip(n_devices: int, device: Union[None, str, torch.device] = None,
                     timeout_s: Optional[float] = 900.0) -> Dict[str, Any]:
    """Every parallel path once over ``n_devices`` ranks; prints the summary
    line and returns rank 0's report (the line, the kernels' launches, the
    spatial forward's collective traffic, the collective route)."""
    from .parallel.launch import spawn
    from .utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = ([f"cuda:{i}" for i in range(n_devices)] if count >= n_devices
                   else ["cuda:0"] * n_devices)
    else:
        devices = ["cpu"] * n_devices
    with tempfile.TemporaryDirectory(prefix="braintpu_torch_dryrun_") as td:
        _write_cases(td, np.random.default_rng(1))
        # tiny shapes: one CPU thread per rank
        reports = spawn(_dryrun_rank, n_devices, devices=devices, args=(n_devices, td),
                        timeout_s=timeout_s, threads=1)
    print(reports[0]["line"])
    return reports[0]
