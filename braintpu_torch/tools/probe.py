"""Probes on the card: the port's int8 kernel, the axial attention's chunk
budget, builds of ``conv_stage`` side by side, and trained model 2.

    python -m braintpu_torch.tools.probe int8 [--log PATH]
    python -m braintpu_torch.tools.probe attn [--log PATH]
    python -m braintpu_torch.tools.probe stage [--trees DIR ...] [--log PATH]
    python -m braintpu_torch.tools.probe trained2 [--checkpoints DIR] [--log PATH]

The port's counterpart of ``tools/tpu_probe.py int8``: the same four shapes
and block arguments (a square 4096^3 product and three stage-GEMM shapes),
each through :func:`braintpu_torch.ops.int8_probe.int8_matmul` on random
int8 operands drawn on the card from a fixed seed over the whole int8 range.
For each shape it prints one JSON line::

    {"probe": "int8:<label>", "ok": ..., "kernel_tops": ..., "library_tops": ...,
     "bound_ms": ..., ...}

``ok`` is true when the kernel's result is bit-equal to the plain version's
and to ``torch._int_mm``'s (cuBLASLt, the library yardstick, which the port
never calls).  ``library_rowmajor_ms`` times ``torch._int_mm`` on the
kernel's own inputs; ``library_colmajor_ms`` on a column-major copy of ``y``
(the layout cuBLASLt's int8 path favours, made once outside the timing).
``library_ms`` and ``library_tops`` are the faster of the two, the library's
best, and ``library`` names its layout.  Times are CUDA-event means over
back-to-back launches after a warm-up; ``kernel_ms`` times the wrapper
call (host work included), ``device_ms`` the kernels alone (their summed
durations in a torch.profiler trace of the same calls, transpose
included), and ``route`` names the wrapper's route.  ``bound_ms`` is the
least time the card could take: the larger of the bytes (operands read
once, result written once) at 3.35 TB/s and the operations at 1,979 TOP/s
dense int8 (H100 SXM data sheet).

``attn`` times ``models.axial.apply_axial_attention`` at the sliding
engine's attention shapes (a mirror chunk of 8 copies of each 128^3 / 64^3
feature map that ``AXIAL_UNET`` and ``AXIAL_UNET_FULL`` attend, bf16, random
parameters from a fixed seed) under each logit budget of
:data:`ATTN_BUDGETS_MIB`: one JSON line per stage with the CUDA-event ms
(mean of 3 after a warm-up), the peak device memory above the inputs and
the largest difference from the output at the smallest budget (the chunking
must not change a bit) per budget.  The module's budget
(``models.axial._MAX_LOGIT_BYTES``) is the one these lines favour.

``stage`` compares builds of the port's kernels on one card.  In each
directory of ``--trees`` (default: this checkout), in the order given and
each in a process of its own that imports ``braintpu_torch`` from there
and builds its kernels there, it times ``conv_stage`` at the main path's
heaviest shape (:data:`STAGE_SHAPE`: model 2's level-0 decoder stage of the
224x224x128 bucket, per-sample affines, input slopes, statistics over every
plane) by device time and by CUDA events, and the two-model fullconv
forward of a random volume of that bucket (folded MODEL1_BN and
MODEL2_GN_LARGE from ``init_params`` seeds, 2 folds each, 8 mirrors): the
host-clock seconds of :data:`FULLCONV_RUNS` forwards after a warm-up, and
``conv_stage``'s device milliseconds in one forward.  A tree only needs a
``braintpu_torch/`` package (for example ``git archive <commit>
braintpu_torch`` unpacked); giving the trees as parent, change, change,
parent puts both builds under the same conditions.

``trained2`` runs trained model 2 (``<checkpoints>/model2/fold_0.npz``,
read by the port's own loader) through the card's kernels on seed 200's
synthetic case at 240x240x155 (fullconv bucket 192x192x128, bf16 as the CLI
runs) and prints one JSON line with three parts:

* ``forward``: one model-2 forward of that fold with the kernels
  (``conv_stage``, ``upconv2x``) against the same fold's plain forward in
  f32 on the card (no TTA): the largest probability difference, the label
  agreement over the bucket and over the voxels either calls tumor, and
  each forward's launches (the f32 forward launches none);
* ``engine``: ``segment``'s engine with ``--models model1,model2 --folds 1``
  (both trained; fullconv, 8-flip TTA): seconds per case (3 after a
  warm-up, each split into preprocessing, the forwards with the labels'
  readback, and the decode with the rest), Dice for WT/TC/ET against the
  generator's ground truth, and the label agreement with the reference's
  committed two-fold-per-model segmentation of the same case
  (``results/flagship_trained``; information only, the fold counts differ);
* ``launches``: each kernel's launches in one engine case beside the
  dispatch's formula (forwards x the kernel layers of the bucket).

It refuses to run, with a message, when fold 0 of model 2 is absent.

It writes nothing unless ``--log PATH`` is given, which appends the lines to
PATH.  It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.int8_probe import int8_matmul, int8_matmul_ref, int8_route

__all__ = ["ATTN_BUDGETS_MIB", "FULLCONV_RUNS", "INT8_SHAPES", "RAGGED_SHAPES", "STAGE_SHAPE",
           "HBM_BYTES_PER_S", "INT8_OPS_PER_S", "cuda_ms", "device_ms", "int8_bound_ms",
           "measure_attention", "measure_int8", "run_attn", "run_int8", "run_stage", "run_trained2",
           "main"]

#: logit budgets (MiB of one chunk's f32 logits) the ``attn`` probe compares
ATTN_BUDGETS_MIB: Tuple[int, ...] = (64, 256, 512, 1024, 2048, 4096, 8192)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, H100 SXM

#: (N, D, H, W, ci1, ci2, co) of the ``stage`` probe's conv_stage call
STAGE_SHAPE: Tuple[int, ...] = (1, 224, 224, 128, 64, 64, 64)
#: timed two-model fullconv forwards per tree (after one warm-up)
FULLCONV_RUNS = 5

#: (label, M, K, N, bm, bn, bk): the shapes and blocks of tools/tpu_probe.py's int8 probe
INT8_SHAPES: Tuple[Tuple[str, int, int, int, int, int, int], ...] = (
    ("4096cube", 4096, 4096, 4096, 512, 512, 512),
    ("stage-l0-bn", 3072, 384, 128, 128, 128, 128),
    ("stage-l0-gn-concat", 3072, 1152, 256, 128, 256, 384),
    ("stage-l1", 1536, 1152, 384, 128, 384, 384),
)

#: three more shapes the card kernel is held to (not the reference probe's):
#: a ragged-valid case, one ragged against the fast route's 128 x 256 x 128
#: tile, and one with K and N off 16 (the byte route); cuBLASLt refuses
#: K = 80 and K = 84, so those two have no library time
RAGGED_SHAPES: Tuple[Tuple[str, int, int, int, int, int, int], ...] = (
    ("ragged-valid", 1024, 128, 384, 128, 128, 128),
    ("ragged-tile", 1000, 80, 48, 8, 16, 16),
    ("ragged-bytes", 1000, 84, 50, 8, 10, 12),
)


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], name: str, iters: int = 20, warmup: int = 3,
              attempts: int = 3) -> float:
    """Mean device milliseconds per call of the kernels whose names contain
    ``name``, over ``iters`` calls of ``fn`` traced by torch.profiler: the
    kernels' own time, without the host time between launches.

    A trace that holds no such kernel is taken again, up to ``attempts``
    traces: now and then (once in a few hundred back-to-back sessions on an
    H100) a profiler session comes back without the device's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"the profiler saw no device time of kernels named *{name}* "
                       f"in {attempts} traces")


def int8_bound_ms(M: int, K: int, N: int) -> Tuple[float, str]:
    """Least time of an (M, K) x (K, N) int8 -> int32 product on the card,
    and what bounds it ("bytes" or "operations")."""
    t_bytes = (M * K + K * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def measure_int8(label: str, M: int, K: int, N: int, bm: int, bn: int, bk: int,
                 seed: int = 0, library: bool = True) -> Dict[str, object]:
    """One shape: the kernel against the plain version and, with ``library``,
    ``torch._int_mm`` (bit equality), and the times beside the bound.
    (cuBLASLt refuses some shapes the kernel takes, e.g. K = 80: pass
    ``library=False`` there.)"""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-128, 128, (M, K), device="cuda", dtype=torch.int8, generator=g)
    y = torch.randint(-128, 128, (K, N), device="cuda", dtype=torch.int8, generator=g)
    got = int8_matmul(x, y, bm=bm, bn=bn, bk=bk)
    ref = int8_matmul_ref(x, y)
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - ref.long()).abs().max().item())
    ok = bool(torch.equal(got, ref))
    library_ms = library_rowmajor_ms = library_colmajor_ms = library_name = None
    if library:
        yc = y.t().contiguous().t()  # column-major: cuBLASLt's int8 layout of choice
        ok = ok and bool(torch.equal(got, torch._int_mm(x, y))
                         and torch.equal(got, torch._int_mm(x, yc)))
        library_rowmajor_ms = cuda_ms(lambda: torch._int_mm(x, y))
        library_colmajor_ms = cuda_ms(lambda: torch._int_mm(x, yc))
        library_ms = min(library_rowmajor_ms, library_colmajor_ms)
        library_name = "torch._int_mm, y " + (
            "column-major" if library_colmajor_ms <= library_rowmajor_ms else "row-major")
    kernel_ms = cuda_ms(lambda: int8_matmul(x, y, bm=bm, bn=bn, bk=bk))
    dev_ms = device_ms(lambda: int8_matmul(x, y, bm=bm, bn=bn, bk=bk), "int8_")
    plain_ms = cuda_ms(lambda: int8_matmul_ref(x, y), iters=5, warmup=1)
    bound_ms, bound_by = int8_bound_ms(M, K, N)
    ops = 2 * M * K * N
    return {
        "probe": f"int8:{label}", "ok": ok, "shape": [M, K, N], "blocks": [bm, bn, bk],
        "kernel_tops": ops / kernel_ms / 1e9,
        "library_tops": ops / library_ms / 1e9 if library_ms else None,
        "route": int8_route(M, N, K, x.data_ptr(), y.data_ptr()),
        "bound_ms": bound_ms, "bound_by": bound_by, "kernel_ms": kernel_ms, "device_ms": dev_ms,
        "library_ms": library_ms, "library_rowmajor_ms": library_rowmajor_ms,
        "library_colmajor_ms": library_colmajor_ms, "plain_ms": plain_ms,
        "library": library_name,
        "max_abs_err": max_abs_err,
    }


def _card() -> Dict[str, object]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip().splitlines()[0]}


def run_int8(log: Optional[str] = None) -> List[Dict[str, object]]:
    """Measure every shape of :data:`INT8_SHAPES`, print one JSON line each
    (and append them to ``log``); returns the records."""
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device; the int8 probe measures the card only")
    card = _card()
    records = []
    for i, (label, M, K, N, bm, bn, bk) in enumerate(INT8_SHAPES):
        rec = {**measure_int8(label, M, K, N, bm, bn, bk, seed=i), "device": card}
        line = json.dumps(rec)
        print(line, flush=True)
        if log:
            with open(log, "a") as f:
                f.write(line + "\n")
        records.append(rec)
    return records


def measure_attention(model: str, spec: Dict[str, object], batch: int = 8, seed: int = 0,
                      budgets_mib=ATTN_BUDGETS_MIB) -> Dict[str, object]:
    """One attention stage (an ``attention_plan`` spec of ``model``) at
    ``batch`` copies: ms, peak memory and difference per logit budget."""
    import numpy as np

    from ..models import axial

    C, shape = int(spec["channels"]), tuple(spec["shape"])
    params = axial.init_axial_params(np.random.default_rng(seed), C, shape, int(spec["heads"]),
                                     int(spec["dim_head"]))
    params = {"pos": {k: (v + 0.1).cuda() for k, v in params["pos"].items()},
              "axes": [{k: v.cuda() for k, v in ax.items()} for ax in params["axes"]]}
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, *shape, C), device="cuda", generator=g).bfloat16()
    summed = spec["kind"] == "attn_block"
    saved = axial._MAX_LOGIT_BYTES
    rows = []
    ref = None
    try:
        for mib in budgets_mib:
            axial._MAX_LOGIT_BYTES = mib * 1024 * 1024
            with torch.inference_mode():
                run = lambda: axial.apply_axial_attention(params, x, int(spec["dim_head"]), summed)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = run()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                if ref is None:
                    ref = out
                diff = float((out.float() - ref.float()).abs().max().item())
                del out
                ms = cuda_ms(run, iters=3, warmup=1)
            rows.append({"budget_mib": mib, "ms": ms, "peak_bytes": peak, "max_abs_diff": diff})
    finally:
        axial._MAX_LOGIT_BYTES = saved
    inner = params["axes"][0]["out"].shape[0]
    return {"probe": f"attn:{model}:{spec['kind']}:{'x'.join(map(str, shape))}",
            "batch": batch, "channels": C, "heads": inner // int(spec["dim_head"]),
            "dim_head": int(spec["dim_head"]), "summed": summed, "budgets": rows,
            "fastest_mib": min(rows, key=lambda r: r["ms"])["budget_mib"],
            "equal_across_budgets": all(r["max_abs_diff"] == 0 for r in rows),
            "module_budget_mib": saved // (1024 * 1024)}


def run_attn(log: Optional[str] = None) -> List[Dict[str, object]]:
    """Every attention stage at 128^3 or 64^3 of the two axial configs."""
    from ..models.unet3d import AXIAL_UNET, AXIAL_UNET_FULL, attention_plan

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device; the attention probe measures the card only")
    card = _card()
    records = []
    for model, cfg in (("axial", AXIAL_UNET), ("axial-full", AXIAL_UNET_FULL)):
        plan = attention_plan(cfg)
        specs = list(plan["decoder"].values()) + list(plan["encoder"].values())
        seen = set()
        for spec in specs:
            key = (spec["kind"], spec["shape"], spec["channels"])
            if spec["shape"][0] < 64 or key in seen:
                continue
            seen.add(key)
            rec = {**measure_attention(model, spec), "device": card}
            line = json.dumps(rec)
            print(line, flush=True)
            if log:
                with open(log, "a") as f:
                    f.write(line + "\n")
            records.append(rec)
            torch.cuda.empty_cache()
    return records


# the ``stage`` probe's body, run in each tree's own process: it uses only
# names that older builds of the port have too, so a parent commit can run it
_STAGE_CHILD = r"""
import json, sys, time
import torch
from braintpu_torch.infer.engine import ModelBundle
from braintpu_torch.infer.fullconv import fullconv_predict
from braintpu_torch.models.unet3d import MODEL1_BN, MODEL2_GN_LARGE, init_params
from braintpu_torch.ops import _build
from braintpu_torch.ops.stage import conv_stage
from braintpu_torch.tools.probe import cuda_ms, device_ms

N, D, H, W, ci1, ci2, co = json.loads(sys.argv[1])
runs = int(sys.argv[2])
t0 = time.perf_counter()
_build.build_all()
build_s = time.perf_counter() - t0
g = torch.Generator(device="cuda").manual_seed(0)
rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
x1, x2 = rnd(N, D, H, W, ci1).bfloat16(), rnd(N, D, H, W, ci2).bfloat16()
w = (rnd(3, 3, 3, ci1 + ci2, co) / (27 * (ci1 + ci2)) ** 0.5).bfloat16()
b = rnd(co) * 0.1
kw = dict(x2=x2, a1=rnd(N, ci1).abs() + 0.5, c1=rnd(N, ci1), a2=rnd(N, ci2).abs() + 0.5,
          c2=rnd(N, ci2), in1_slope=0.01, in2_slope=0.01, stats=True)
call = lambda: conv_stage(x1, w, b, **kw)
rec = {"stage_device_ms": device_ms(call, "conv_stage_kernel"), "stage_event_ms": cuda_ms(call)}
del x1, x2, kw
bundles = [ModelBundle.from_folds(cfg, [init_params(cfg, s) for s in seeds]).to("cuda")
           for cfg, seeds in ((MODEL1_BN, (0, 1)), (MODEL2_GN_LARGE, (1000, 1001)))]
vol = rnd(D, H, W, 4)
def forward():
    with torch.inference_mode():
        return [fullconv_predict(m.fold_params, vol, m.cfg, num_mirror=8, folded=m.folded)
                for m in bundles]
forward()
torch.cuda.synchronize()
secs = []
for _ in range(runs):
    t = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t)
rec.update(build_s=build_s, fullconv_s=secs,
           fullconv_stage_device_ms=device_ms(forward, "conv_stage_kernel", iters=1, warmup=0))
print("STAGE_PROBE " + json.dumps(rec), flush=True)
"""


def run_stage(trees: Sequence[str], log: Optional[str] = None) -> List[Dict[str, object]]:
    """The ``stage`` probe: one record per entry of ``trees``, in order."""
    import os
    import statistics

    card = _card()
    records = []
    for i, tree in enumerate(trees):
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        out = subprocess.run([sys.executable, "-c", _STAGE_CHILD, json.dumps(STAGE_SHAPE),
                              str(FULLCONV_RUNS)], cwd=root, env=env, capture_output=True,
                             text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"stage probe in {tree} failed (rc {out.returncode}):\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        rec = json.loads(next(ln for ln in out.stdout.splitlines()
                              if ln.startswith("STAGE_PROBE "))[len("STAGE_PROBE "):])
        rec = {"probe": "stage", "order": i, "tree": str(tree), "shape": list(STAGE_SHAPE),
               "fullconv_s_min": min(rec["fullconv_s"]),
               "fullconv_s_median": statistics.median(rec["fullconv_s"]), **rec, **card}
        line = json.dumps(rec)
        print(line, flush=True)
        if log:
            with open(log, "a") as f:
                f.write(line + "\n")
        records.append(rec)
    return records


def _kernel_layers(cfg, bucket: Tuple[int, int, int]) -> Dict[str, int]:
    """Kernel launches of one N = 1 bf16 forward of ``cfg`` at ``bucket``,
    as the dispatch decides them (the layer lists of ``models.unet3d``)."""
    from ..models import unet3d as U

    dt = cfg.compute_dtype
    if cfg.norm == "batch":
        main = sum(U.choose_impl(s, (3, 3, 3), st, co, dt) == "kernel"
                   for s, st, co in U.conv_layers(cfg, bucket))
        key = "conv3d_tap_merged"
    else:
        main = sum(U.choose_stage_impl(s, (3, 3, 3), st, co, c2, dt) == "kernel"
                   for s, st, co, c2 in U.deferred_layers(cfg, bucket))
        key = "conv_stage"
    ups = sum(U.upconv_supported(s, co) for s, co in U.upconv_layers(cfg, bucket))
    return {key: main, "upconv2x": ups}


def run_trained2(checkpoints: str, log: Optional[str] = None) -> Dict[str, object]:
    """The ``trained2`` probe (module docstring); returns its record."""
    import dataclasses
    import statistics
    import tempfile
    import time

    from ..ckpt.npz import load_pytree_npz, params_from_jax
    from ..cli import build_parser, load_engine
    from ..infer.engine import ModelBundle
    from ..infer.fullconv import fullconv_predict
    from ..infer.sliding_window import region_probs_to_labels
    from ..io import nifti
    from ..io.brats import find_cases, load_case_volumes
    from ..labels.convert import internal_to_brats2025, normalize_to_brats2025
    from ..metrics.segmentation import evaluate_segmentation
    from ..models.unet3d import MODEL1_BN, MODEL2_GN_LARGE
    from ..ops.conv3d import conv3d_tap_merged
    from ..ops.stage import conv_stage
    from ..ops.upconv import upconv2x
    from ..pre.preprocess import preprocess_case
    from ..train.synthetic import write_synth_case
    from ..utils.device import resolve_device

    fold0 = Path(checkpoints) / "model2" / "fold_0.npz"
    if not fold0.is_file():
        raise SystemExit(f"probe trained2: {fold0} is absent; this probe runs trained model 2 "
                         "and needs its fold 0")
    dev = resolve_device(None)  # the card; raises without one
    root = Path(__file__).resolve().parents[2]
    flagship = root / "results" / "flagship_trained" / "BraTS-SYN-00200-000" / \
        "BraTS-SYN-00200-000.nii.gz"
    kernels = {"conv3d_tap_merged": conv3d_tap_merged, "conv_stage": conv_stage,
               "upconv2x": upconv2x}

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    rec: Dict[str, object] = {"probe": "trained2", "checkpoint": str(fold0), **_card()}
    with tempfile.TemporaryDirectory(prefix="braintpu_torch_trained2_") as tmp:
        case_dir = write_synth_case(Path(tmp) / "in", "BraTS-SYN-00200-000", seed=200,
                                    shape=(240, 240, 155))
        case = find_cases(case_dir)[0]
        data, _, _ = load_case_volumes(case)

        # (a) one forward, kernels (bf16) against the plain version in f32
        params = params_from_jax(load_pytree_npz(fold0), MODEL2_GN_LARGE)
        div = 2**MODEL2_GN_LARGE.num_pool
        vol = preprocess_case(data, patch_size=(div,) * 3, pad_multiple=div,
                              device=dev).data.movedim(0, -1).contiguous()
        bucket = tuple(int(s) for s in vol.shape[:3])
        forward: Dict[str, object] = {"bucket": list(bucket)}
        probs = {}
        for label, cfg in (("kernels_bf16", MODEL2_GN_LARGE),
                           ("plain_f32", dataclasses.replace(MODEL2_GN_LARGE,
                                                             compute_dtype=torch.float32))):
            bundle = ModelBundle.from_folds(cfg, [params]).to(dev)
            reset()
            # the f32 forward in f32: no TF32 in cuDNN's convolutions or matmuls
            tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            try:
                with torch.inference_mode():
                    probs[label] = fullconv_predict(bundle.fold_params, vol, cfg, num_mirror=1,
                                                    folded=bundle.folded)
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            forward[f"launches_{label}"] = counts()
            del bundle
        k, f = probs["kernels_bf16"], probs["plain_f32"]
        lk, lf = region_probs_to_labels(k), region_probs_to_labels(f)
        tumor = (lk > 0) | (lf > 0)
        forward.update(
            max_abs_prob_err=(k - f).abs().max().item(),
            label_agreement=(lk == lf).float().mean().item(),
            tumor_voxels=int(tumor.sum().item()),
            tumor_label_agreement=((lk == lf) & tumor).sum().item() / max(int(tumor.sum()), 1),
            launches_formula=_kernel_layers(MODEL2_GN_LARGE, bucket))
        del probs, k, f, lk, lf, tumor, vol
        rec["forward"] = forward

        # (b) the two-model engine, both trained, one fold each
        engine = load_engine(build_parser().parse_args(
            ["segment", "--input", str(case_dir), "--output", str(Path(tmp) / "out"),
             "--checkpoints", str(checkpoints), "--models", "model1,model2", "--folds", "1"]))
        gt = nifti.load(case.seg_path).get_fdata(dtype="float32").round().astype("int32")
        reset()
        seg, info = engine.predict_case(case)  # the warm-up, counted for (c)
        torch.cuda.synchronize()
        launches = counts()
        secs, parts = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            seg, info = engine.predict_case(case)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            parts.append({"preprocess": info["preprocess_s"], "forwards_and_labels":
                          info["predict_s"], "decode_and_rest": secs[-1] - info["total_s"]})
        ev = evaluate_segmentation(normalize_to_brats2025(seg).astype("int32"),
                                   normalize_to_brats2025(gt).astype("int32"))
        ref = internal_to_brats2025(nifti.load(flagship).get_fdata(dtype="float32"))
        eb = tuple(int(s) for s in info["bucket_shape"])
        rec["engine"] = {
            "case": "BraTS-SYN-00200-000 240x240x155", "bucket": list(eb),
            "models": "model1 fold 0 + model2 fold 0 (trained), fullconv, 8-flip TTA",
            "s_per_case": secs, "s_per_case_min": min(secs),
            "s_per_case_median": statistics.median(secs), "s_parts": parts,
            "dice": {r: v["dice"] for r, v in ev["compound"].items()},
            "label_agreement_with_committed_flagship": float((seg == ref).mean()),
            "flagship_note": "the committed file was made with 2 + 2 folds (information only)"}
        want = {name: 0 for name in kernels}
        for cfg in (MODEL1_BN, MODEL2_GN_LARGE):
            for name, n in _kernel_layers(cfg, eb).items():
                want[name] += 8 * n  # 1 fold x 8 mirrors
        rec["launches"] = {"per_case": launches, "formula": want,
                           "equal": launches == want and all(v > 0 for v in want.values())}
        del engine
    line = json.dumps(rec)
    print(line, flush=True)
    if log:
        with open(log, "a") as f:
            f.write(line + "\n")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="braintpu_torch.tools.probe", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=["int8", "attn", "stage", "trained2"])
    ap.add_argument("--log", metavar="PATH", help="append the JSON lines to PATH")
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="stage: the checkouts to compare, in order (default: this one)")
    ap.add_argument("--checkpoints", metavar="DIR",
                    default=str(Path(__file__).resolve().parents[2] / "results" / "trained_synth"
                                / "checkpoints"),
                    help="trained2: the checkpoint root (model1/, model2/fold_0.npz)")
    args = ap.parse_args(argv)
    if args.probe == "trained2":
        rec = run_trained2(args.checkpoints, args.log)
        fw = rec["forward"]
        ok = (fw["label_agreement"] >= 0.999 and rec["launches"]["equal"]
              and fw["launches_kernels_bf16"] == {"conv3d_tap_merged": 0,
                                                  **fw["launches_formula"]}
              and not any(fw["launches_plain_f32"].values()))
        return 0 if ok else 1
    if args.probe == "stage":
        run_stage(args.trees or [str(Path(__file__).resolve().parents[2])], args.log)
        return 0
    if args.probe == "attn":
        return 0 if all(r["equal_across_budgets"] for r in run_attn(args.log)) else 1
    records = run_int8(args.log)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
