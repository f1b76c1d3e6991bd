"""Probes on the card: the port's int8 kernel, and the axial attention's
chunk budget.

    python -m braintpu_torch.tools.probe int8 [--log PATH]
    python -m braintpu_torch.tools.probe attn [--log PATH]
    python -m braintpu_torch.tools.probe stage [--trees DIR ...] [--log PATH]

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
           "measure_attention", "measure_int8", "run_attn", "run_int8", "run_stage", "main"]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="braintpu_torch.tools.probe", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=["int8", "attn", "stage"])
    ap.add_argument("--log", metavar="PATH", help="append the JSON lines to PATH")
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="stage: the checkouts to compare, in order (default: this one)")
    args = ap.parse_args(argv)
    if args.probe == "stage":
        run_stage(args.trees or [str(Path(__file__).resolve().parents[2])], args.log)
        return 0
    if args.probe == "attn":
        return 0 if all(r["equal_across_budgets"] for r in run_attn(args.log)) else 1
    records = run_int8(args.log)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
