#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``braintpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``braintpu_torch/csrc`` (nvcc, seconds,
all at once), holds every kernel against its plain PyTorch version at the
shapes the main paths give it, then drives the main paths on synthetic BraTS
cases: MODEL1_BN (full width, the two trained folds in
``results/trained_synth/checkpoints/model1``, fullconv mode, 8-flip mirror
TTA), checked against the generator's ground truth; one full-width
MODEL2_GN_LARGE forward whose every ``conv_stage`` launch is held against
the plain version on the same activations; and the two-model ensemble that
``cli segment`` runs by default, with model 2's folds drawn by
``init_params`` (seeds 1000, 1001: what ``--random-weights`` gives when the
model-2 checkpoints are absent), timed on a 240x240x155 case and profiled
with torch.profiler (device time by kernel category, the device's idle
share; ``--trace DIR`` keeps the Chrome trace).  Every phase prints its
wall seconds.  The last line is ``{"ok": true, "device": {...}}``; any
failed check raises and the script exits non-zero without it.  It needs a
CUDA card (it has no CPU path) and writes only ``braintpu_torch/_build/``
in the repository; cases and outputs go to a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
CKPTS = ROOT / "results" / "trained_synth" / "checkpoints"
FLAGSHIP = ROOT / "results" / "flagship_trained" / "BraTS-SYN-00200-000" / "BraTS-SYN-00200-000.nii.gz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM
TOL = 0.02  # x max|plain|: bf16 output resolution (the CPU parity tests' bound)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"# phase {name} ...", flush=True)
    yield
    print(f"# phase {name}: {time.perf_counter() - t0:.2f}s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def bucket_of(case_dir: Path):
    """The fullconv bucket a case runs at (crop to nonzero, pad to 32)."""
    from braintpu_torch.io.brats import find_cases, load_case_volumes
    from braintpu_torch.pre.preprocess import crop_to_nonzero

    data, _, _ = load_case_volumes(find_cases(case_dir)[0])
    _, _, info = crop_to_nonzero(data)
    return info.cropped_shape, tuple(max(32, -(-s // 32) * 32) for s in info.cropped_shape)


def check_kernel(torch, shape, co, seed: int) -> dict:
    """The kernel against its plain version at one main-path shape, and its times."""
    import torch.nn.functional as F

    from braintpu_torch.ops.conv3d import conv3d_tap_merged, conv3d_tap_merged_ref

    N, D, H, W, ci = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, device="cuda", generator=g) / (27 * ci) ** 0.5).bfloat16()
    b = torch.randn(co, device="cuda", generator=g) * 0.1
    err, tol = 0.0, 0.0
    for slope in (None, 0.01):
        y = conv3d_tap_merged(x, w, b, slope)
        ref = conv3d_tap_merged_ref(x, w, b, slope)
        torch.cuda.synchronize()
        e = (y.float() - ref.float()).abs().max().item()
        bound = TOL * ref.float().abs().max().item()
        if not e <= bound:
            raise AssertionError(f"kernel disagrees at {shape}->{co} slope={slope}: {e} > {bound}")
        err, tol = max(err, e), max(tol, bound)
    kernel_ms = cuda_ms(torch, lambda: conv3d_tap_merged(x, w, b, 0.01))
    plain_ms = cuda_ms(torch, lambda: conv3d_tap_merged_ref(x, w, b, 0.01))
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    bb = b.bfloat16()
    library_ms = cuda_ms(torch, lambda: F.conv3d(xc, wc, bb, padding=1))
    vox = N * D * H * W
    flops = 2 * vox * 27 * ci * co
    nbytes = (x.numel() + w.numel() + vox * co) * 2 + b.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {
        "shape": [N, D, H, W, ci, co], "max_abs_err": err, "tol": tol, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / kernel_ms / 1e9,
    }


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def stage_errors(torch, got, ref, rows=None) -> dict:
    """conv_stage vs its plain version: y within TOL of max|plain|, s1 within
    1e-3 of the sum of |y| and s2 within 1e-3 of s2 (both f32 sums of the
    same f32 conv output in another order, with atomics on the card)."""
    y, s1, s2 = got
    ry, r1, r2 = ref
    err = (y.float() - ry.float()).abs().max().item()
    tol = TOL * ry.float().abs().max().item()
    sum_abs = ry.float().abs().sum(dim=(1, 2, 3))
    e1 = ((s1 - r1).abs() / sum_abs.clamp_min(1e-30)).max().item()
    e2 = ((s2 - r2).abs() / r2.clamp_min(1e-30)).max().item()
    if not (err <= tol and e1 <= 1e-3 and e2 <= 1e-3):
        raise AssertionError(f"conv_stage disagrees at {rows}: y {err} > {tol} or "
                             f"s1 rel {e1} / s2 rel {e2} > 1e-3")
    return {"max_abs_err": err, "tol": tol, "s1_rel_err": e1, "s2_rel_err": e2}


def check_stage(torch, shape, co, ci2, seed: int) -> dict:
    """conv_stage against its plain version at one main-path shape (random
    per-sample affines with c != 0, input slopes, the skip input where the
    decoder has one, statistics; and once with an output slope), and its
    times beside the library sequence that computes the same function."""
    import torch.nn.functional as F

    from braintpu_torch.ops.stage import conv_stage, conv_stage_ref

    N, D, H, W, ci1 = shape
    ci = ci1 + ci2
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    x1 = rnd(*shape).bfloat16()
    x2 = rnd(N, D, H, W, ci2).bfloat16() if ci2 else None
    w = (rnd(3, 3, 3, ci, co) / (27 * ci) ** 0.5).bfloat16()
    b = rnd(co) * 0.1
    aff = {"a1": rnd(N, ci1).abs() + 0.5, "c1": rnd(N, ci1)}
    if ci2:
        aff.update(a2=rnd(N, ci2).abs() + 0.5, c2=rnd(N, ci2))
    kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01 if ci2 else None, stats=True, **aff)
    got = conv_stage(x1, w, b, **kw)
    ref = conv_stage_ref(x1, w, b, **kw)
    torch.cuda.synchronize()
    r = stage_errors(torch, got, ref, (shape, ci2, co))
    yo = conv_stage(x1, w, b, x2=x2, out_slope=0.01)
    ro = conv_stage_ref(x1, w, b, x2=x2, out_slope=0.01)
    eo = (yo.float() - ro.float()).abs().max().item()
    if not eo <= TOL * ro.float().abs().max().item():
        raise AssertionError(f"conv_stage with an output slope disagrees at {shape}, {ci2} -> {co}")
    r["max_abs_err"] = max(r["max_abs_err"], eo)
    del got, ref, yo, ro

    kernel_ms = cuda_ms(torch, lambda: conv_stage(x1, w, b, **kw))
    plain_ms = cuda_ms(torch, lambda: conv_stage_ref(x1, w, b, **kw))
    wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    bb = b.bfloat16()

    def library():  # materialize, concat, cuDNN bf16 conv (channels-last), f32 sums
        ts = [torch.nn.functional.leaky_relu(x1.float() * aff["a1"][:, None, None, None]
                                             + aff["c1"][:, None, None, None], 0.01).bfloat16()]
        if ci2:
            ts.append(torch.nn.functional.leaky_relu(
                x2.float() * aff["a2"][:, None, None, None]
                + aff["c2"][:, None, None, None], 0.01).bfloat16())
        t = torch.cat(ts, dim=-1) if ci2 else ts[0]
        yl = F.conv3d(t.permute(0, 4, 1, 2, 3), wc, bb, padding=1).float()
        return yl.sum(dim=(2, 3, 4)), (yl * yl).sum(dim=(2, 3, 4))

    library_ms = cuda_ms(torch, library)
    vox = N * D * H * W
    flops = 2 * vox * 27 * ci * co
    nbytes = 2 * (vox * ci + w.numel() + vox * co) + 4 * (co + 2 * N * ci + 2 * N * co)
    bound_ms, bound_by = _bound(nbytes, flops)
    r.update({"shape": [N, D, H, W, ci1, ci2, co], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "materialize + cat + F.conv3d bf16 + f32 sums",
              "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / kernel_ms / 1e9})
    return r


def check_upconv(torch, shape, co, seed: int) -> dict:
    """upconv2x against its plain version at one main-path shape, and its
    times beside cuDNN's bf16 ``conv_transpose3d`` (which the port never calls)."""
    import torch.nn.functional as F

    from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref

    N, D, H, W, ci = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
    w = (torch.randn(ci, 2, 2, 2, co, device="cuda", generator=g) / ci ** 0.5).bfloat16()
    y = upconv2x(x, w)
    ref = upconv2x_ref(x, w)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"upconv2x disagrees at {shape}->{co}: {err} > {tol}")
    kernel_ms = cuda_ms(torch, lambda: upconv2x(x, w))
    plain_ms = cuda_ms(torch, lambda: upconv2x_ref(x, w))
    xc = x.permute(0, 4, 1, 2, 3)
    wt = w.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    library_ms = cuda_ms(torch, lambda: F.conv_transpose3d(xc, wt, stride=2))
    vox = N * D * H * W
    flops = 2 * vox * ci * 8 * co
    nbytes = 2 * (vox * ci + w.numel() + 8 * vox * co)
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"shape": [N, D, H, W, ci, co], "max_abs_err": err, "tol": tol,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.conv_transpose3d bf16", "bound_ms": bound_ms, "bound_by": bound_by,
            "gbps": nbytes / kernel_ms / 1e6}


#: device-time categories of the profile, by kernel-name fragment (first match)
PROFILE_GROUPS = (
    ("conv_stage", ("conv_stage_kernel",)),
    ("conv3d_tap_merged", ("conv3d_tap_merged_kernel",)),
    ("upconv2x", ("upconv2x_kernel",)),
    ("cudnn convolution", ("fprop", "dgrad", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "Kernel2")),
    ("reduction", ("reduce_kernel",)),
)


def profile_case(torch, run, out_dir: Optional[Path]) -> None:
    """Trace ``run()`` with torch.profiler: device time of the kernels (not
    of the host ops that launch them) by name and by category, the device's
    busy share of the wall time (one stream: the sum of kernel times), and,
    with ``out_dir``, a gzipped Chrome trace there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["elementwise and copies"] = 0.0
    for ms, _, key in rows:
        name = next((g for g, frags in PROFILE_GROUPS if any(f in key for f in frags)),
                    "elementwise and copies")
        groups[name] += ms
    print(json.dumps({"profile": {
        "wall_s": wall, "device_busy_s": busy_ms / 1e3, "device_idle_share": 1 - busy_ms / 1e3 / wall,
        "device_ms_by_category": groups,
        "top_kernels": [{"ms": ms, "count": n, "name": k[:120]} for ms, n, k in rows[:20]]}}),
        flush=True)
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        trace = out_dir / "trace.json"
        prof.export_chrome_trace(str(trace))
        with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        trace.unlink()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", metavar="DIR",
                    help="write the profiled case's Chrome trace to DIR/trace.json.gz")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    with phase("1 device"):
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script has no CPU path")
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi()
        print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
        print(f"nvidia-smi: {smi}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("tf32 off for cuDNN convolutions and matmuls (f32 plain versions stay f32)")

    from braintpu_torch.cli import build_parser, load_engine
    from braintpu_torch.infer.engine import ModelBundle
    from braintpu_torch.io import nifti
    from braintpu_torch.io.brats import find_cases, load_case_volumes
    from braintpu_torch.labels.convert import internal_to_brats2025, normalize_to_brats2025
    from braintpu_torch.metrics.segmentation import evaluate_segmentation
    from braintpu_torch.models import unet3d
    from braintpu_torch.models.unet3d import (MODEL1_BN, MODEL2_GN_LARGE, choose_impl,
                                              choose_stage_impl, conv_layers, deferred_layers,
                                              forward_flops, init_params, upconv_layers,
                                              upconv_supported)
    from braintpu_torch.ops import _build
    from braintpu_torch.ops.conv3d import conv3d_tap_merged
    from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
    from braintpu_torch.ops.upconv import upconv2x
    from braintpu_torch.pre.preprocess import preprocess_case
    from braintpu_torch.train.synthetic import write_synth_case

    kernels = {"conv3d_tap_merged": conv3d_tap_merged, "conv_stage": conv_stage,
               "upconv2x": upconv2x}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def tap_layers(bucket):
        return [(s, co) for s, st, co in conv_layers(MODEL1_BN, bucket)
                if choose_impl(s, (3, 3, 3), st, co, MODEL1_BN.compute_dtype) == "kernel"]

    def stage_layers(bucket):
        return [(s, co, c2) for s, st, co, c2 in deferred_layers(MODEL2_GN_LARGE, bucket)
                if choose_stage_impl(s, (3, 3, 3), st, co, c2, MODEL2_GN_LARGE.compute_dtype)
                == "kernel"]

    def up_layers(cfg, bucket):
        return [(s, co) for s, co in upconv_layers(cfg, bucket) if upconv_supported(s, co)]

    with phase("2 build"):
        print(f"sources: {_build.build_all()} -> {_build.BUILD_DIR.relative_to(ROOT)}")

    with tempfile.TemporaryDirectory(prefix="braintpu_torch_smoke_") as tmp:
        tmp = Path(tmp)
        with phase("3 cases"):
            anchor = write_synth_case(tmp / "in", "BraTS-SYN-00200-000", seed=200)
            brats_size = write_synth_case(tmp / "in", "BraTS-SYN-00050-000", seed=50,
                                          shape=(240, 240, 155))
            flagship = write_synth_case(tmp / "flag", "BraTS-SYN-00200-000", seed=200,
                                        shape=(240, 240, 155))
            buckets = {}
            for name, case in (("anchor", anchor), ("brats_size", brats_size),
                               ("flagship_geometry", flagship)):
                crop, buckets[name] = bucket_of(case)
                print(f"{name}: crop {crop} -> bucket {buckets[name]}")
            main_bucket = buckets["brats_size"]

        results = {name: [] for name in kernels}  # per-shape checks, all buckets
        with phase("4 kernels vs plain"):
            shapes = []
            for bucket in buckets.values():
                for k in tap_layers(bucket):
                    if k not in shapes:
                        shapes.append(k)
            for i, (shape, co) in enumerate(shapes):
                r = check_kernel(torch, shape, co, seed=i)
                r["buckets"] = [list(b) for b in buckets.values() if (shape, co) in tap_layers(b)]
                results["conv3d_tap_merged"].append(r)
                print(json.dumps({"conv3d_tap_merged": r}), flush=True)
            shapes = []
            for bucket in buckets.values():
                for k in stage_layers(bucket):
                    if k not in shapes:
                        shapes.append(k)
            for i, (shape, co, ci2) in enumerate(shapes):
                r = check_stage(torch, shape, co, ci2, seed=100 + i)
                r["buckets"] = [list(b) for b in buckets.values()
                                if (shape, co, ci2) in stage_layers(b)]
                results["conv_stage"].append(r)
                print(json.dumps({"conv_stage": r}), flush=True)
            shapes = []
            for bucket in buckets.values():
                for cfg in (MODEL1_BN, MODEL2_GN_LARGE):
                    for k in up_layers(cfg, bucket):
                        if k not in shapes:
                            shapes.append(k)
            for i, (shape, co) in enumerate(shapes):
                r = check_upconv(torch, shape, co, seed=200 + i)
                r["buckets"] = [list(b) for b in buckets.values()
                                if any((shape, co) in up_layers(c, b)
                                       for c in (MODEL1_BN, MODEL2_GN_LARGE))]
                results["upconv2x"].append(r)
                print(json.dumps({"upconv2x": r}), flush=True)
            torch.cuda.empty_cache()

        # model 1 alone: the first slice's main path, now also through upconv2x
        engine_args = build_parser().parse_args(
            ["segment", "--input", str(anchor), "--output", str(tmp / "out"),
             "--checkpoints", str(CKPTS), "--models", "model1", "--folds", "2"])
        engine = load_engine(engine_args)

        def segment(eng, case_dir, out_name=None):
            case = find_cases(case_dir)[0]
            out = tmp / "out" / out_name if out_name else None
            seg, info = eng.predict_case(case, out)
            torch.cuda.synchronize()
            gt = nifti.load(case.seg_path).get_fdata(dtype="float32").round().astype("int32")
            ev = evaluate_segmentation(normalize_to_brats2025(seg).astype("int32"),
                                       normalize_to_brats2025(gt).astype("int32"))
            return seg, info, {k: round(v["dice"], 6) for k, v in ev["compound"].items()}

        def expect_counts(got, want, what):
            print(f"{what}: launches per case {got} (16 forwards x the dispatch's layers: {want})")
            if got != want or not all(got[k] > 0 for k in want):
                raise AssertionError(f"{what}: kernel launches {got} != {want}")

        def model1_launches(bucket):
            return {"conv3d_tap_merged": 16 * len(tap_layers(bucket)),
                    "upconv2x": 16 * len(up_layers(MODEL1_BN, bucket))}

        with phase("5 parity anchor (model 1 main path)"):
            reset_counts()
            seg, info, dice = segment(engine, anchor, "BraTS-SYN-00200-000.nii.gz")
            got = {k: v for k, v in counts().items() if k != "conv_stage"}
            expect_counts(got, model1_launches(buckets["anchor"]), f"bucket {info['bucket_shape']}")
            print(f"Dice vs generated ground truth: {dice}; volumes {info['volumes_cm3']}")
            if counts()["conv_stage"] != 0:
                raise AssertionError("model 1 launched conv_stage")
            if min(dice.values()) < 0.99:
                raise AssertionError(f"Dice below 0.99: {dice}")

        def timed(eng, case_dir):
            eng.predict_case(find_cases(case_dir)[0])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                _, inf = eng.predict_case(find_cases(case_dir)[0])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return times, inf, torch.cuda.max_memory_allocated()

        with phase("6 BraTS-size case, model 1 alone"):
            times, info50, peak = timed(engine, brats_size)
            _, _, dice50 = segment(engine, brats_size)
            print(json.dumps({
                "case": "BraTS-SYN-00050-000 240x240x155", "models": "model1 (2 trained folds)",
                "bucket": info50["bucket_shape"],
                "s_per_case_min": min(times), "s_per_case_median": statistics.median(times),
                "s_per_case": times, "kernel_launches_per_case": model1_launches(main_bucket),
                "max_memory_allocated_bytes": peak,
                "analytic_tflop_per_case": forward_flops(MODEL1_BN, main_bucket) * 16 / 1e12,
                "dice": dice50,
                "note": "s/case is predict_case: NIfTI decode, preprocessing, 16 forwards, labels; "
                        "Dice is information only: seed 50 is a hard case for model 1 alone",
            }), flush=True)
            segf, infof, dicef = segment(engine, flagship)
            # the committed flagship segmentation holds internal labels (the
            # pipeline converts in its own stage): compare in BraTS-2025 space
            ref = internal_to_brats2025(nifti.load(FLAGSHIP).get_fdata(dtype="float32"))
            agree = float((segf == ref).mean())
            print(f"seed 200 at 240x240x155 (bucket {infof['bucket_shape']}): Dice {dicef}; "
                  f"label agreement with the committed two-model flagship {agree:.6f} "
                  "(information only)")
            if min(dicef.values()) < 0.99:
                raise AssertionError(f"Dice below 0.99 at 240x240x155: {dicef}")
        del engine
        torch.cuda.empty_cache()

        with phase("7 model 2 on real activations"):
            # one full-width MODEL2_GN_LARGE forward of the seed-50 volume;
            # every conv_stage launch is held against the plain version on
            # the very same inputs, affines and skips (a wrapper of this
            # script around the module's op, removed after the forward)
            bundle = ModelBundle.from_folds(MODEL2_GN_LARGE, [init_params(MODEL2_GN_LARGE, 1000)])
            params = bundle.to(torch.device("cuda")).fold_params[0]
            data, _, _ = load_case_volumes(find_cases(brats_size)[0])
            pre = preprocess_case(data, patch_size=(32,) * 3, pad_multiple=32,
                                  device=torch.device("cuda"))
            x = pre.data.movedim(0, -1)[None].contiguous()
            checked = []

            def checking_stage(x1, w, b, **kw):
                out = conv_stage(x1, w, b, **kw)
                ref = conv_stage_ref(x1, w, b, **kw)
                torch.cuda.synchronize()
                r = stage_errors(torch, out, ref, (tuple(x1.shape), kw.get("x2") is not None))
                checked.append(r)
                return out

            reset_counts()
            unet3d.conv_stage = checking_stage
            try:
                with torch.inference_mode():
                    logits = unet3d.apply_unet(params, x, MODEL2_GN_LARGE, folded=False)
                torch.cuda.synchronize()
            finally:
                unet3d.conv_stage = conv_stage
            want = len(stage_layers(tuple(x.shape[1:4])))
            print(json.dumps({"model2_forward": {
                "bucket": list(x.shape[1:4]), "conv_stage_launches_checked": len(checked),
                "dispatch_layers": want,
                "max_abs_err": max(r["max_abs_err"] for r in checked),
                "max_tol": max(r["tol"] for r in checked),
                "max_s1_rel_err": max(r["s1_rel_err"] for r in checked),
                "max_s2_rel_err": max(r["s2_rel_err"] for r in checked),
                "launches": counts(), "logits_shape": list(logits.shape)}}), flush=True)
            if len(checked) != want or counts()["conv_stage"] != want:
                raise AssertionError(f"checked {len(checked)} conv_stage launches, expected {want}")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("model 2 forward gave non-finite logits")
            del bundle, params, x, logits, pre
            torch.cuda.empty_cache()

        with phase("8 two-model engine (main path)"):
            # model 1: trained folds 0-1; model 2: init_params seeds 1000,
            # 1001, from a checkpoint root that holds model 1 only
            root = tmp / "ckpt"
            (root / "model1").mkdir(parents=True)
            for f in (0, 1):
                (root / "model1" / f"fold_{f}.npz").symlink_to(CKPTS / "model1" / f"fold_{f}.npz")
            engine2 = load_engine(build_parser().parse_args(
                ["segment", "--input", str(brats_size), "--output", str(tmp / "out2"),
                 "--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
                 "--random-weights"]))
            reset_counts()
            _, info2, dice2 = segment(engine2, brats_size)
            main_launches = counts()
            if tuple(info2["bucket_shape"]) != tuple(main_bucket):
                raise AssertionError(f"bucket {info2['bucket_shape']} != {main_bucket}")
            want = dict(model1_launches(main_bucket))
            want["conv_stage"] = 16 * len(stage_layers(main_bucket))
            want["upconv2x"] += 16 * len(up_layers(MODEL2_GN_LARGE, main_bucket))
            expect_counts(main_launches, want, f"two models at bucket {info2['bucket_shape']}")
            times2, _, peak2 = timed(engine2, brats_size)
            print(json.dumps({
                "case": "BraTS-SYN-00050-000 240x240x155",
                "models": "model1 (2 trained folds) + model2 (init_params seeds 1000, 1001)",
                "bucket": info2["bucket_shape"], "s_per_case_min": min(times2),
                "s_per_case_median": statistics.median(times2), "s_per_case": times2,
                "kernel_launches_per_case": main_launches, "max_memory_allocated_bytes": peak2,
                "analytic_tflop_per_case": (forward_flops(MODEL1_BN, main_bucket)
                                            + forward_flops(MODEL2_GN_LARGE, main_bucket))
                                           * 16 / 1e12,
                "dice": dice2,
                "note": "Dice is information only: model 2's weights are random",
            }), flush=True)

        with phase("9 profile of one two-model case"):
            profile_case(torch, lambda: segment(engine2, brats_size),
                         Path(args.trace) if args.trace else None)

    def heaviest(name):
        at_main = [r for r in results[name] if list(main_bucket) in r["buckets"]]
        return max(at_main, key=lambda r: r["bound_ms"])

    replaces = {
        "conv3d_tap_merged": ("braintpu/ops/conv3d_pallas.py:245",
                              "braintpu/ops/conv3d_pallas.py::conv3d_tap_merged"),
        "conv_stage": ("braintpu/ops/stage_pallas.py:420",
                       "braintpu/ops/stage_pallas.py::conv_stage"),
        "upconv2x": ("braintpu/ops/upconv_pallas.py:167",
                     "braintpu/ops/upconv_pallas.py::upconv2x"),
    }
    line = []
    for name in kernels:
        h = heaviest(name)
        line.append({
            "name": name, "route": "cuda", "source": f"braintpu_torch/csrc/{name}.cu",
            "replaces": replaces[name][0], "replaces_function": replaces[name][1],
            "checked": True, "launches": main_launches[name],
            "launches_on_main_path": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "shape": h["shape"], "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        })
    print(f"# total wall: {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
