#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``braintpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``braintpu_torch/csrc`` (nvcc, seconds,
all at once) and checks that every library holds Hopper wgmma in its SASS
(``HGMMA`` in the two convolutions and ``upconv2x``, ``IGMMA`` in
``int8_matmul``; ``cuobjdump -sass``), holds every kernel against its
plain PyTorch version at the shapes the main paths give it (printing each
kernel's time, its device time where the wrapper's host work matters, and
its launch plan), then drives the main paths on synthetic BraTS
cases: MODEL1_BN (full width, the two trained folds in
``results/trained_synth/checkpoints/model1``, fullconv mode, 8-flip mirror
TTA), checked against the generator's ground truth; one full-width
MODEL2_GN_LARGE forward whose every ``conv_stage`` launch is held against
the plain version on the same activations; and the two-model ensemble that
``cli segment`` runs by default, with model 2's folds drawn by
``init_params`` (seeds 1000, 1001: what ``--random-weights`` gives when the
model-2 checkpoints are absent), timed on a 240x240x155 case and profiled
with torch.profiler (device time by kernel category, the device's idle
share; ``--trace DIR`` keeps the Chrome trace).  Two more paths: the int8
probe entry point (``python -m braintpu_torch.tools.probe int8``, the only
caller of the ``int8_matmul`` kernel), whose every shape is held bit-equal
to the plain version and to ``torch._int_mm``; and the report half of
``cli pipeline`` (``Pipeline.run_case`` with the model-1 engine on the
seed-200 case at 240x240x155: convert, evaluate, the six feature steps, the
governed report and the PDF, each output checked).  The sliding-window
recipe (``--mode sliding``: 128^3 patches at 50 % overlap, the mirror copies
batched along N, 8 for model 1 and 4 for model 2) drives the same three
kernels at their batch shapes: phase 4 holds each against its plain version
there, phase 6c segments the seed-200 case at 240x240x155 with model 1
(Dice against the ground truth, launches = patches x 8/N x folds x the
kernel layers of one forward), phase 8b times the two-model sliding engine
beside the fullconv one, and phase 8c runs the label ensemble.  The host
side: phase 2 builds the native host library (``braintpu_torch/native``,
g++), phase 4c holds its decode bit-equal to the Python decode and times
both, phase 6d times the feature steps with its EDT and with scipy's, and
phase 8d runs ``cli segment``'s loop over three cases with and without the
case prefetcher.  The serving slice: phase 4d holds the RAG store's
device top-k (``torch.matmul`` + ``torch.topk`` on a 32,768 x 8,192 f32
matrix) against numpy's and times both routes; phase 10 runs ``cli
serve``'s server in this process with the two-model engine (warm-up, one
job alone, then two jobs in flight at once, report / PDF / metrics / chat
requests, launches against the formula, the served labels against a direct
``Pipeline.run_case``); phase 10b starts ``python -m braintpu_torch.cli
serve`` as a process, serves one job and stops it with SIGINT; phase 10c
runs ``check-env``, which must pass on the card.  The training slice:
phase 4e holds the tap kernel without LeakyReLU at the training forward's
band shapes (level 1 of a 128^3 patch at batch 2, both models) and its
autograd backward (dx, dw, db against f32 plain gradients), with the
forward, ``F.conv3d`` and backward times; phase 11 trains MODEL1_BN and
MODEL2_GN_LARGE at full width (128^3, batch 2, bf16; 3 warm-up steps, then
20 and 10 timed ones: s/step, peak memory, tap launches per step against
the dispatch's formula, finite losses); phase 11b runs
``tools/train_synthetic.py``'s recipe (model 1, 64^3, batch 2, LR 0.01,
mirror) for 300 steps on the synthetic dataset it writes (seeds 0-11),
prints its losses beside the reference's log, exports the fold to npz and
segments held-out seed 100 with it; phase 11c runs ``python -m
braintpu_torch.cli train`` as a process twice and checks the resume;
phase 11d converts a full-width model-1 state dict in nnU-Net naming
(``convert-checkpoint``) and segments from the ``.model``, a raw nnU-Net
tree and the npz, which must give the same labels.  The axial families and
batching: phase 12 segments seed 50 at 240x240x155 with ``--models axial``
(AXIAL_UNET at full width, two ``init_params`` folds, 8-flip TTA; sliding,
the mode ``load_engine`` picks for it): s/case, peak memory, tap and
``upconv2x`` launches against the dispatch's formula, the attention's share
of device time (its calls bracketed by CUDA events under torch.profiler),
finite probabilities, one 128^3 x 8 forward against the same forward with
every kernel replaced by its plain version (label agreement >= 0.999) and
one attention stage chunked against unchunked (bit equality); 12b does the
same for ``axial-full`` with one fold; 12c runs ``cli segment --models
axial`` as a process (sliding without ``--mode``; ``--mode fullconv`` exits
with the reference's message); 12d trains AXIAL_UNET at 128^3 x 2 (3
warm-up and 10 timed steps) and runs ``cli train --model axial`` for 2
steps; 12e runs phase 8's two-model fullconv engine through
``predict_cases_batched`` at batch 2 over seeds 50, 55 and 200 (two
buckets, one padded batch): per-case seconds against serial, peak memory,
launches against the formula, labels against per-case ``predict_case``
(>= 0.9999: ``conv_stage`` sums its statistics with atomics), and ``cli
segment --batch-cases 2`` as a process.  The feature statistics on the card
and the single-card utilities: phase 13a runs the six feature steps
(``run_all_steps``) on the seed-200 case at 240x240x155 under each route of
``BRAINTPU_DEVICE_FEATURES`` in turns, twice (the host route, each device
group alone, all groups), prints each route's step seconds (min of 2) beside
the host's, holds every field of each route's summary to the host's, and
prints which groups win (the decision behind ``MEASURED_WIN_GROUPS``);
phase 10 runs its served pair once more on the other side of that decision;
13b runs ``cli segment --trace-dir`` as a process and ``cli profile-report``
on its trace, whose kernel table must name the three segmentation kernels;
13c runs ``cli visualize`` and ``cli compare`` on seed 200 (where
matplotlib is installed; without it both must stop with a message, and the
overlay arrays are checked instead) and holds ``resize_trilinear`` /
``resize_nearest`` on the card to the CPU.  Phase 6d
pins the host route (``BRAINTPU_DEVICE_FEATURES=0``): it compares two host
EDTs.  Parallelism across devices (phase 14, :func:`sharded_phases`; the
machine shows one card, so multi-rank runs are ``gloo`` ranks sharing it):
14a runs the mirror-sharded and the X-sharded two-model fullconv of the
seed-200 case on one ``nccl`` rank against the unsharded engine, 14b the
mirror-sharded one on two ranks, 14c each model's X-sharded forward on two
ranks (peak memory, halo and statistics traffic, launches per rank), 14d
the data-parallel model-1 step at 128^3 x 2 against one process, 14e the
patch runner and ``dryrun_multichip(2)``, 14f the rank bodies of
``segment --dp-devices 2`` with ``--spatial-shard`` and with
``--batch-cases 2``, 14g every kernel against its plain version at every
launch key the sharded ranks recorded; phase 4 also holds ``conv_stage``'s
output-plane window (an X slab's own planes) against the plain version.
Phase 15 (:func:`closing_surface`) runs the reference's last public
functions on the card on seed 200: ``confusion_counts`` and
``evaluate_pair`` on card tensors against the host's counts,
``stack_folds`` of the trained model-1 folds on the card against the host
stack, ``param_count`` of each fold, and ``estimate_activation_bytes`` of
MODEL1_BN beside one forward's peak memory.  Phase 16
(:func:`conv_impl_phase`) runs phase 8's two-model engine on the seed-200
case at 240x240x155 under ``UNetConfig.conv_impl`` "auto", "pallas" and
"xla3d": s/case, launches against ``conv_routes``, peak memory, labels
against "auto", every launched kernel against its plain version at its
launch keys, and an unknown value raising; ``--only-conv-impl`` runs
phases 1, 2 and 16 alone.
Every phase prints its wall seconds.  The last line is ``{"ok": true, "device": {...}}``; any
failed check raises and the script exits non-zero without it.  It needs a
CUDA card (it has no CPU path) and writes only ``braintpu_torch/_build/``
in the repository; cases and outputs go to a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parent
CKPTS = ROOT / "results" / "trained_synth" / "checkpoints"
FLAGSHIP = ROOT / "results" / "flagship_trained" / "BraTS-SYN-00200-000" / "BraTS-SYN-00200-000.nii.gz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM
TOL = 0.02  # x max|plain|: bf16 output resolution (the CPU parity tests' bound)
#: phase 4 times each plain version over 5 calls after 1 (the kernels and
#: the library calls over 20 after 3): a depth cut for the smoke's time
PLAIN_ITERS = {"iters": 5, "warmup": 1}


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


#: the wgmma opcode each library's SASS must hold: HGMMA (bf16) in the three
#: segmentation kernels, IGMMA (s8) in int8_matmul's fast path
SASS_WGMMA = {"conv3d_tap_merged": "HGMMA", "conv_stage": "HGMMA", "upconv2x": "HGMMA",
              "int8_matmul": "IGMMA"}


def sass_check(build) -> dict:
    """Every library must hold Hopper wgmma of its type in its SASS
    (:data:`SASS_WGMMA`): a build that quietly kept mma.sync (HMMA, IMMA)
    on a fast path does not pass.  Returns the count of each library's
    warpgroup-MMA opcodes by name."""
    home = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").resolve().parent
    cuobjdump = shutil.which("cuobjdump") or str(home / "cuobjdump")
    found = {}
    for name, want in SASS_WGMMA.items():
        lib = build._lib_path(name)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        ops = {}
        for op in re.findall(r"\b([A-Z]+GMMA)\b", sass):
            ops[op] = ops.get(op, 0) + 1
        found[name] = ops
        if not ops.get(want):
            raise AssertionError(f"no {want} in the SASS of {lib.name} (warpgroup MMA opcodes: "
                                 f"{ops}): not the wgmma kernel")
    return found


def toolchain_present() -> bool:
    """Whether this machine has g++ and zlib's header (what the native host
    library needs)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    probe = subprocess.run([gxx, "-x", "c++", "-fsyntax-only", "-"], input="#include <zlib.h>\n",
                           capture_output=True, text=True, timeout=60)
    return probe.returncode == 0


def check_kernel(torch, shape, co, seed: int) -> dict:
    """The kernel against its plain version at one main-path shape, and its times."""
    import torch.nn.functional as F

    from braintpu_torch.ops.conv3d import conv3d_tap_merged, conv3d_tap_merged_ref
    from braintpu_torch.ops.conv_plan import conv_plan
    from braintpu_torch.tools.probe import device_ms

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
    dev_ms = device_ms(lambda: conv3d_tap_merged(x, w, b, 0.01), "conv3d_tap_merged_kernel")
    plain_ms = cuda_ms(torch, lambda: conv3d_tap_merged_ref(x, w, b, 0.01), **PLAIN_ITERS)
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
        "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / kernel_ms / 1e9, "plan": conv_plan(N, D, H, W, ci, co).describe(),
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
    if y.shape != ry.shape:
        raise AssertionError(f"conv_stage at {rows}: y {tuple(y.shape)}, plain {tuple(ry.shape)}")
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

    from braintpu_torch.ops.conv_plan import conv_plan
    from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
    from braintpu_torch.tools.probe import device_ms

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
    dev_ms = device_ms(lambda: conv_stage(x1, w, b, **kw), "conv_stage_kernel")
    plain_ms = cuda_ms(torch, lambda: conv_stage_ref(x1, w, b, **kw), **PLAIN_ITERS)
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
    r.update({"shape": [N, D, H, W, ci1, ci2, co], "kernel_ms": kernel_ms, "device_ms": dev_ms,
              "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "materialize + cat + F.conv3d bf16 + f32 sums",
              "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / kernel_ms / 1e9,
              "plan": conv_plan(N, D, H, W, ci1, co, ci2, stage=True).describe()})
    return r


def check_upconv(torch, shape, co, seed: int) -> dict:
    """upconv2x against its plain version at one main-path shape, and its
    times (event time of the wrapper call, device time of the kernel)
    beside cuDNN's bf16 ``conv_transpose3d`` (which the port never calls) and
    ``fill_`` of the output tensor (the card writing the same bytes alone)."""
    import torch.nn.functional as F

    from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref
    from braintpu_torch.ops.upconv_plan import upconv_plan
    from braintpu_torch.tools.probe import device_ms

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
    dev_ms = device_ms(lambda: upconv2x(x, w), "upconv2x_kernel")
    fill_ms = cuda_ms(torch, lambda: y.fill_(1.0))  # the same output bytes, written alone
    plain_ms = cuda_ms(torch, lambda: upconv2x_ref(x, w), **PLAIN_ITERS)
    xc = x.permute(0, 4, 1, 2, 3)
    wt = w.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    library_ms = cuda_ms(torch, lambda: F.conv_transpose3d(xc, wt, stride=2))
    vox = N * D * H * W
    flops = 2 * vox * ci * 8 * co
    nbytes = 2 * (vox * ci + w.numel() + 8 * vox * co)
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"shape": [N, D, H, W, ci, co], "max_abs_err": err, "tol": tol,
            "kernel_ms": kernel_ms, "device_ms": dev_ms, "fill_ms": fill_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library": "F.conv_transpose3d bf16",
            "bound_ms": bound_ms, "bound_by": bound_by, "gbps": nbytes / kernel_ms / 1e6,
            "device_gbps": nbytes / dev_ms / 1e6,
            "plan": upconv_plan(N, D, H, W, ci, co).describe()}


def labelled_queries():
    """The 33 labelled queries of ``tests/test_rag_eval.py``, read from its
    source (that test module imports the reference package, which this
    script must not)."""
    import ast

    tree = ast.parse((ROOT / "tests" / "test_rag_eval.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "LABELED_QUERIES")
    return ast.literal_eval(node.value)


def check_rag_topk(torch, seed: int = 4) -> dict:
    """The vector store's device route (one ``torch.matmul`` + ``torch.topk``
    on the card) against numpy's matvec + ``argsort`` on the same matrix:
    32,768 x 8,192 f32 (1 GiB), the built-in KB's embedded rows plus unit
    rows from ``default_rng(seed)``; the 33 labelled queries.  Indices must
    be equal where scores do not tie, scores within 1e-5 relative.  Times:
    median per query of the route as a caller sees it (upload of the query,
    matmul, topk, results back), of the device work alone (CUDA events), and
    of the host route on the same matrix."""
    import numpy as np

    from braintpu_torch.rag import (HashedNgramEmbedder, KBDocument, VectorStore,
                                    build_vector_store, builtin_knowledge_base)

    docs = builtin_knowledge_base()
    texts = [d.embed_text for d in docs]
    emb = HashedNgramEmbedder().fit_idf(texts)
    rows, dim, k = 32768, emb.dim, 5
    matrix = np.empty((rows, dim), np.float32)
    matrix[:len(docs)] = emb.embed(texts)
    rnd = np.random.default_rng(seed).standard_normal((rows - len(docs), dim), dtype=np.float32)
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    matrix[len(docs):] = rnd
    del rnd
    pad = [KBDocument(f"random row {i}", "", "", "seeded", "") for i in range(len(docs), rows)]
    store = VectorStore(docs + pad, matrix, emb)  # device None: the card
    if store.route != "device":
        raise AssertionError(f"a {rows}-row store took the {store.route} route")
    t0 = time.perf_counter()
    dev = store._device_copy()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if dev.device.type != "cuda":
        raise AssertionError(f"the store's matrix went to {dev.device}, not the card")
    small = build_vector_store(docs)
    queries = [emb.embed([q])[0] for q, _, _ in labelled_queries()]
    worst, reordered_ties, same_titles = 0.0, 0, 0
    for (text, _, _), q in zip(labelled_queries(), queries):
        vals, idx = store.topk(q, k)
        scores = matrix @ q
        want = np.argsort(-scores)[:k]
        rel = float((np.abs(vals - scores[want]) / np.abs(scores[want])).max())
        worst = max(worst, rel)
        if not rel <= 1e-5:
            raise AssertionError(f"device top-k scores off by {rel} (rel) for {text!r}")
        if not np.array_equal(idx, want):
            # a difference is allowed only between rows whose scores tie
            if not np.allclose(scores[idx], scores[want], rtol=1e-6, atol=0):
                raise AssertionError(f"device top-k {idx} != numpy {want} for {text!r}")
            reordered_ties += 1
        same_titles += [d.title for d, _ in store.retrieve(text, 2)] == \
            [d.title for d, _ in small.retrieve(text, 2)]
    route_s, device_ms, host_s = [], [], []
    for q in queries:
        t0 = time.perf_counter()
        store.topk(q, k)  # returns numpy: synchronised
        route_s.append(time.perf_counter() - t0)
        qd = torch.from_numpy(q).cuda()
        device_ms.append(cuda_ms(torch, lambda: torch.topk(torch.matmul(dev, qd), k), iters=10))
    for q in queries[:11]:
        t0 = time.perf_counter()
        np.argsort(-(matrix @ q))[:k]
        host_s.append(time.perf_counter() - t0)
    nbytes = matrix.nbytes + dim * 4 + k * 12
    return {"rows": rows, "dim": dim, "matrix_bytes": matrix.nbytes, "k": k,
            "queries": len(queries), "route": store.route, "upload_s": upload_s,
            "max_rel_score_err": worst, "tie_reorders": reordered_ties,
            "top2_titles_as_7_row_store": same_titles,
            "route_ms_median": statistics.median(route_s) * 1e3,
            "device_ms_median": statistics.median(device_ms),
            "host_numpy_ms_median": statistics.median(host_s) * 1e3,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def http(url: str, data: Optional[bytes] = None, headers=None, method=None, timeout=120):
    """(status code, body, headers, seconds) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers), time.perf_counter() - t0


def multipart(fields: dict, files: dict):
    """A multipart/form-data body and its content type."""
    import uuid

    boundary = f"----braintpu-smoke-{uuid.uuid4().hex}"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n".encode()
             for k, v in fields.items()]
    for name, data in files.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                     f"filename=\"{name}.nii.gz\"\r\nContent-Type: application/octet-stream"
                     "\r\n\r\n".encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def case_files(case_dir: Path, with_seg: bool = True) -> dict:
    mods = ("t1", "t1ce", "t2", "flair") + (("seg",) if with_seg else ())
    return {m: (case_dir / f"{case_dir.name}_{m}.nii.gz").read_bytes() for m in mods}


def submit(url: str, case_dir: Path, as_json: bool = False) -> str:
    """POST /api/analyze: multipart with the ground truth, or JSON with
    RFC-2045-wrapped base64 (newlines every 76 characters)."""
    import base64

    if as_json:
        files = {m: base64.encodebytes(v).decode() for m, v in case_files(case_dir).items()}
        body = json.dumps({"case_id": case_dir.name, "files": files}).encode()
        ctype = "application/json"
    else:
        body, ctype = multipart({"case_id": case_dir.name}, case_files(case_dir))
    code, resp, _, _ = http(url + "/api/analyze", body, {"Content-Type": ctype}, "POST")
    if code != 200:
        raise AssertionError(f"analyze {case_dir.name}: HTTP {code} {resp[:300]!r}")
    return json.loads(resp)["job_id"]


def wait_jobs(url: str, jobs: dict, t_submit: dict, timeout_s: float = 600.0,
              latencies: Optional[list] = None) -> dict:
    """Poll /api/status every 50 ms until every job is done or in error;
    returns {job: (status, seconds from its submit to the poll that saw it
    end)}.  Every job is waited for, so no job thread is inside a kernel
    when the server shuts down."""
    ended, deadline = {}, time.perf_counter() + timeout_s
    while len(ended) < len(jobs) and time.perf_counter() < deadline:
        for job in jobs:
            if job in ended:
                continue
            code, resp, _, s = http(url + f"/api/status/{job}")
            if latencies is not None:
                latencies.append(s)
            status = json.loads(resp) if code == 200 else {"status": f"HTTP {code}"}
            if status["status"] in ("done", "error") or code != 200:
                ended[job] = (status, time.perf_counter() - t_submit[job])
        time.sleep(0.05)
    if len(ended) < len(jobs):
        raise AssertionError(f"jobs still running after {timeout_s} s: {set(jobs) - set(ended)}")
    return ended


def stage_spans(events) -> dict:
    """Seconds of each stage from its first 'start' to its 'ok' in a journal."""
    t = {}
    for e in events:
        t.setdefault(e["stage"], {}).setdefault(e["status"], e["t"])
    return {s: v["ok"] - v["start"] for s, v in t.items() if "ok" in v and "start" in v}


#: device-time categories of the profile, by kernel-name fragment (first match)
PROFILE_GROUPS = (
    ("conv_stage", ("conv_stage_kernel",)),
    ("conv3d_tap_merged", ("conv3d_tap_merged_kernel",)),
    ("upconv2x", ("upconv2x_kernel",)),
    ("cudnn convolution", ("fprop", "dgrad", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "Kernel2")),
    ("reduction", ("reduce_kernel",)),
)


def profile_case(torch, run, out_dir: Optional[Path], what: str = "fullconv") -> dict:
    """Trace ``run()`` with torch.profiler: device time of the kernels (not
    of the host ops that launch them) by name and by category, the device's
    busy share of the wall time (one stream: the sum of kernel times), and,
    with ``out_dir``, a gzipped Chrome trace there.  Returns the record it
    prints."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # a session now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      reverse=True)
        if rows:
            break
    busy_ms = sum(r[0] for r in rows)
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["elementwise and copies"] = 0.0
    for ms, _, key in rows:
        name = next((g for g, frags in PROFILE_GROUPS if any(f in key for f in frags)),
                    "elementwise and copies")
        groups[name] += ms
    record = {
        "what": what, "wall_s": wall, "device_busy_s": busy_ms / 1e3,
        "device_idle_share": 1 - busy_ms / 1e3 / wall,
        "device_ms_by_category": groups,
        "top_kernels": [{"ms": ms, "count": n, "name": k[:120]} for ms, n, k in rows[:20]]}
    print(json.dumps({"profile": record}), flush=True)
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        trace = out_dir / "trace.json"
        prof.export_chrome_trace(str(trace))
        with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        trace.unlink()
    return record


#: the reference's training log of the recipe below (tools/train_synthetic.py, fold 0)
REF_TRAIN_LOG = ROOT / "results" / "trained_synth" / "train_log.jsonl"
#: the training phases' two models at full width (phase 11)
TRAIN_MODELS = ("model1", "model2")


def check_tap_train(torch, shape, co, seed: int) -> dict:
    """The tap kernel without LeakyReLU at one training shape: its forward
    against the plain version, and the autograd Function's dx, dw and db
    against f32 plain gradients (autograd through ``F.conv3d`` of the same
    bf16 operands, TF32 off), each within TOL of max|plain|; then the kernel
    forward's, the plain version's, ``F.conv3d``'s and the backward's times."""
    import torch.nn.functional as F

    from braintpu_torch.ops import conv3d as tap

    N, D, H, W, ci = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, device="cuda", generator=g) / (27 * ci) ** 0.5).bfloat16()
    b = torch.randn(co, device="cuda", generator=g) * 0.1
    dy = torch.randn(N, D, H, W, co, device="cuda", generator=g).bfloat16()
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y = tap.conv3d_tap_merged(xg, wg, bg)  # through the autograd Function
    y.backward(dy)
    xf, wf, bf = x.float().requires_grad_(), w.float().requires_grad_(), b.clone().requires_grad_()
    yf = F.conv3d(xf.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2), bf, padding=1)
    yf.permute(0, 2, 3, 4, 1).backward(dy.float())
    torch.cuda.synchronize()
    errors = {}
    for name, got, want in (("y", y, tap.conv3d_tap_merged_ref(x, w, b)), ("dx", xg.grad, xf.grad),
                            ("dw", wg.grad, wf.grad), ("db", bg.grad, bf.grad)):
        e = (got.float() - want.float()).abs().max().item()
        tol = TOL * want.float().abs().max().item()
        if not e <= tol:
            raise AssertionError(f"tap kernel {name} disagrees at {shape}->{co}: {e} > {tol}")
        errors[name] = {"max_abs_err": e, "tol": tol}
    del xg, wg, bg, y, xf, wf, bf, yf
    kernel_ms = cuda_ms(torch, lambda: tap.conv3d_tap_merged(x, w, b))
    plain_ms = cuda_ms(torch, lambda: tap.conv3d_tap_merged_ref(x, w, b))
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    bb = b.bfloat16()
    library_ms = cuda_ms(torch, lambda: F.conv3d(xc, wc, bb, padding=1))
    backward_ms = cuda_ms(torch, lambda: tap._conv_backward(x, w, dy, None))
    vox = N * D * H * W
    flops = 2 * vox * 27 * ci * co
    bound, by = _bound((x.numel() + w.numel() + vox * co) * 2 + b.numel() * 4, flops)
    return {"shape": [N, D, H, W, ci, co], "errors": errors,
            "max_abs_err": max(e["max_abs_err"] for e in errors.values()),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "backward_ms": backward_ms, "bound_ms": bound, "bound_by": by,
            "tflops": flops / kernel_ms / 1e9, "backward_tflops_f32": 2 * flops / backward_ms / 1e9}


def train_run(torch, cfg, batches, warmup: int, timed: int, kernels: dict) -> dict:
    """``train_step`` from ``init_params(cfg, 0)`` on the card: ``warmup``
    steps, then ``timed`` steps (host clock around each step, which ends by
    reading the loss) with every kernel count at 0 before and read after.
    Fails on a non-finite loss, on tap launches per step off the dispatch's
    formula, or on any launch of the inference-only kernels."""
    import numpy as np

    from braintpu_torch.models.unet3d import choose_impl, conv_layers, init_params
    from braintpu_torch.train.trainer import TrainConfig, create_train_state, train_step

    tc = TrainConfig()
    state = create_train_state(init_params(cfg, 0), tc, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_batch = batches[0]["image"].shape[0]
    patch = tuple(batches[0]["image"].shape[1:4])
    for i in range(warmup):
        state, m = train_step(state, batches[i % len(batches)], cfg, tc, gen)
        float(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    secs, losses, norms = [], [], []
    for i in range(timed):
        t0 = time.perf_counter()
        state, m = train_step(state, batches[(warmup + i) % len(batches)], cfg, tc, gen)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = len([1 for s, st, co in conv_layers(cfg, patch, n_batch)
                    if choose_impl(s, (3, 3, 3), st, co, cfg.compute_dtype) == "kernel"])
    want = {name: (per_step * timed if name == "conv3d_tap_merged" else 0) for name in kernels}
    if launches != want or per_step == 0:
        raise AssertionError(f"training launches {launches} != {want} ({per_step} tap layers "
                             "per step)")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"non-finite loss or gradient norm: {losses} {norms}")
    del state
    torch.cuda.empty_cache()
    return {"patch": list(patch), "batch": n_batch, "compute_dtype": str(cfg.compute_dtype),
            "steps_timed": timed, "warmup_steps": warmup, "s_per_step": secs,
            "s_per_step_min": min(secs), "s_per_step_median": statistics.median(secs),
            "max_memory_allocated_bytes": peak, "launches": launches,
            "tap_launches_per_step": launches["conv3d_tap_merged"] / timed,
            "tap_launches_per_step_formula": per_step, "loss": losses, "grad_norm": norms}


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def nnunet_state_dict(torch, tree, cfg) -> dict:
    """The reference-layout tree as an nnU-Net ``Generic_UNet`` state dict
    (torch layouts and names): what ``convert_state_dict`` reads back."""
    import numpy as np

    def conv(prefix, blk):
        out = {f"{prefix}.conv.weight": blk["w"].transpose(4, 3, 0, 1, 2),
               f"{prefix}.conv.bias": blk["b"], f"{prefix}.instnorm.weight": blk["scale"],
               f"{prefix}.instnorm.bias": blk["shift"]}
        if "mean" in blk:
            out[f"{prefix}.instnorm.running_mean"] = blk["mean"]
            out[f"{prefix}.instnorm.running_var"] = blk["var"]
        return out

    P, cps = cfg.num_pool, cfg.conv_per_stage
    sd = {}
    for d, stage in enumerate(tree["encoder"]):
        for c, blk in enumerate(stage):
            sd.update(conv(f"conv_blocks_context.{d}.blocks.{c}", blk))
    for c, blk in enumerate(tree["bottleneck"]):
        sd.update(conv(f"conv_blocks_context.{P}.0.blocks.{c}" if c < cps - 1
                       else f"conv_blocks_context.{P}.1.blocks.0", blk))
    for u, st in enumerate(tree["decoder"]):
        sd[f"tu.{u}.weight"] = st["up"]["w"].transpose(0, 4, 1, 2, 3)
        for c, blk in enumerate(st["blocks"]):
            sd.update(conv(f"conv_blocks_localization.{u}.0.blocks.{c}" if c < cps - 1
                           else f"conv_blocks_localization.{u}.1.blocks.0", blk))
        sd[f"seg_outputs.{u}.weight"] = st["seg"]["w"].transpose(4, 3, 0, 1, 2)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


#: the reference's refusal of ``--mode fullconv`` with an axial model (braintpu/cli.py)
AXIAL_FULLCONV_EXIT = ("--mode fullconv is incompatible with axial models ['axial'] "
                       "(patch-shape-bound positional embeddings); use --mode sliding")


def attention_profile(torch, run, what: str) -> dict:
    """``profile_case`` of ``run()`` with every ``apply_axial_attention``
    call bracketed by CUDA events: the attention's device milliseconds (the
    events' spans; the attention's kernels fill them, one stream) against
    the device's busy milliseconds, and the profile's categories."""
    from braintpu_torch.models import axial, unet3d

    real = axial.apply_axial_attention
    spans = []

    def timed_attention(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    # the decoder variant calls it from unet3d, the blocks from axial
    axial.apply_axial_attention = unet3d.apply_axial_attention = timed_attention
    try:
        record = profile_case(torch, lambda: (spans.clear(), run()), None, what=what)
    finally:
        axial.apply_axial_attention = unet3d.apply_axial_attention = real
    torch.cuda.synchronize()
    attn_ms = sum(s.elapsed_time(e) for s, e in spans)
    busy_ms = record["device_busy_s"] * 1e3
    return {"attention_calls": len(spans), "attention_device_ms": attn_ms,
            "device_busy_ms": busy_ms, "attention_share_of_device_time": attn_ms / busy_ms,
            "device_idle_share": record["device_idle_share"],
            "device_ms_by_category": record["device_ms_by_category"]}


#: the float fields of a feature summary held to the host's at 5e-2
#: relative (the SNR block: a background std over a few thousand voxels at
#: a p10 boundary); every other float at 2e-3 relative or absolute (the
#: summary rounds its ratios to 3 decimals), everything else equal
SUMMARY_LOOSE = ("snr",)


def summary_diff(got, want, path="", out=None) -> list:
    """The fields of ``got`` (a feature summary) that leave the host's
    tolerance (:data:`SUMMARY_LOOSE`), as (path, got, want)."""
    out = [] if out is None else out
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(got) | set(want)):
            if k == "analysis_date":  # the clock, not a feature
                continue
            if k not in got or k not in want:
                out.append((f"{path}/{k}", k in got, k in want))
            else:
                summary_diff(got[k], want[k], f"{path}/{k}", out)
    elif isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        for i, (g, w) in enumerate(zip(got, want)):
            summary_diff(g, w, f"{path}[{i}]", out)
    elif isinstance(want, float) and isinstance(got, (int, float)) \
            and not isinstance(got, bool):
        rtol = 5e-2 if any(k in path.lower() for k in SUMMARY_LOOSE) else 2e-3
        if not abs(got - want) <= max(rtol * abs(want), 2e-3):
            out.append((path, got, want))
    elif got != want:
        out.append((path, got, want))
    return out


#: the feature steps whose host passes each device group replaces
GROUP_STEPS = {"stats": ("step1_sequence_findings", "step5_quality"),
               "mass": ("step2_mass_effect",), "morph": ("step4_morphology",),
               "artifacts": ("step5_quality",), "parenchyma": ("step6_normal_structures",)}


def feature_routes(case_dir: Path, seg_path: Path, device, out_dir: Path,
                   repeats: int = 2) -> dict:
    """``run_all_steps`` on one case under every route of
    ``BRAINTPU_DEVICE_FEATURES`` (the host, each device group alone, all
    groups), the routes in turns, ``repeats`` times, each run on a fresh
    context of the decoded case on ``device``.  Returns per route the total
    and per-step seconds (min over the repeats) and the summary fields that
    leave the host's tolerance, per group the seconds of the steps it
    replaces on the card and on the host, and the winning groups: those
    whose steps run faster on the card, when all groups together beat the
    host route."""
    import numpy as np

    from braintpu_torch.features import FeatureContext, run_all_steps
    from braintpu_torch.features.devstats import GROUPS
    from braintpu_torch.io import nifti
    from braintpu_torch.io.brats import MODALITIES, find_cases, load_case_volumes

    case = find_cases(case_dir)[0]
    data, affine, zooms = load_case_volumes(case)
    seg = np.round(nifti.load(seg_path).get_fdata(dtype=np.float32)).astype(np.int32)
    seg = np.where(seg == 4, 3, seg).astype(np.int32)  # as FeatureContext.load reads it
    routes = ("0", *GROUPS, "all")
    runs = {r: {"total_s": [], "steps_s": []} for r in routes}
    summaries = {}
    saved = os.environ.get("BRAINTPU_DEVICE_FEATURES")
    try:
        for rep in range(repeats):
            for route in routes:
                os.environ["BRAINTPU_DEVICE_FEATURES"] = route
                ctx = FeatureContext.from_arrays(
                    {m: data[i] for i, m in enumerate(MODALITIES)}, seg, zooms=zooms[:3],
                    case_id=case.case_id, affine=affine, device=device)
                spans, last = {}, [None, 0.0]

                def progress(step, spans=spans, last=last):
                    now = time.perf_counter()
                    if last[0] is not None:
                        spans[last[0]] = now - last[1]
                    last[0], last[1] = step, now

                t0 = time.perf_counter()
                res = run_all_steps(case_dir, seg_path, out_dir / f"{route}_{rep}", ctx=ctx,
                                    progress=progress)
                t1 = time.perf_counter()
                spans[last[0]] = t1 - last[1]  # the last step + the report and JSON writes
                runs[route]["total_s"].append(t1 - t0)
                runs[route]["steps_s"].append(spans)
                used = sorted(ctx._device_route)
                if used != sorted(GROUPS if route == "all" else [] if route == "0" else [route]):
                    raise AssertionError(f"route {route!r} ran the device groups {used}")
                summaries[route] = res["llm_summary"]
    finally:
        if saved is None:
            os.environ.pop("BRAINTPU_DEVICE_FEATURES", None)
        else:
            os.environ["BRAINTPU_DEVICE_FEATURES"] = saved
    record = {}
    for route, r in runs.items():
        record[route] = {
            "total_s": r["total_s"], "total_s_min": min(r["total_s"]),
            "steps_s_min": {k: min(s[k] for s in r["steps_s"]) for k in r["steps_s"][0]},
            "summary_fields_off": summary_diff(summaries[route], summaries["0"])}
    # the set is decided group by group on the steps each group replaces:
    # one upload per case serves every group of the set, so within the set
    # a group costs only its own steps; and the set must beat the host
    # route end to end (route 'all')
    own = {}
    for g in GROUPS:
        steps = GROUP_STEPS[g]
        own[g] = {"card_s": sum(record[g]["steps_s_min"][k] for k in steps),
                  "host_s": sum(record["0"]["steps_s_min"][k] for k in steps), "steps": steps}
    set_wins = record["all"]["total_s_min"] < record["0"]["total_s_min"]
    winners = sorted(g for g in GROUPS if set_wins and own[g]["card_s"] < own[g]["host_s"])
    return {"routes": record, "own_steps": own, "winners": winners}


def check_stage_window(torch, shape, co, ci2, window, seed: int) -> dict:
    """conv_stage over a window of output planes (what an X-sharded forward
    asks for) against the plain version's planes and sums; correctness
    only."""
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
    kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01 if ci2 else None, stats=True,
              out_planes=window, **aff)
    got = conv_stage(x1, w, b, **kw)
    ref = conv_stage_ref(x1, w, b, **kw)
    torch.cuda.synchronize()
    lo, hi = window
    r = stage_errors(torch, got, ref, (shape, ci2, co, window))
    r.update({"shape": [N, D, H, W, ci1, ci2, co], "out_planes": [lo, hi]})
    return r


def check_launch_key(torch, name: str, key: tuple, seed: int) -> dict:
    """One kernel against its plain version on random inputs of the kind a
    launch key records (``braintpu_torch.ops._build.launch_keys``: the
    shapes, and for conv_stage the affines, slopes and statistics window);
    correctness only, at the tolerances of phase 4."""
    from braintpu_torch.ops.conv3d import conv3d_tap_merged, conv3d_tap_merged_ref
    from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
    from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)

    def close(got, ref):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} disagrees at launch key {key}: {err} > {tol}")
        return {"max_abs_err": err, "tol": tol}

    if name == "conv3d_tap_merged":
        N, D, H, W, ci, co, slope = key
        x = rnd(N, D, H, W, ci).bfloat16()
        w = (rnd(3, 3, 3, ci, co) / (27 * ci) ** 0.5).bfloat16()
        b = rnd(co) * 0.1
        return close(conv3d_tap_merged(x, w, b, slope), conv3d_tap_merged_ref(x, w, b, slope))
    if name == "upconv2x":
        N, D, H, W, ci, co = key
        x = rnd(N, D, H, W, ci).bfloat16()
        w = (rnd(ci, 2, 2, 2, co) / ci ** 0.5).bfloat16()
        return close(upconv2x(x, w), upconv2x_ref(x, w))
    N, D, H, W, ci1, ci2, co, d1, d2, sl1, sl2, slo, stats, lo, hi = key
    aff = {}
    for k, ci, dims in (("1", ci1, d1), ("2", ci2, d2)):
        if dims is not None:
            shape = (N, ci) if dims == 2 else (ci,)
            aff.update({f"a{k}": rnd(*shape).abs() + 0.5, f"c{k}": rnd(*shape)})
    x1 = rnd(N, D, H, W, ci1).bfloat16()
    x2 = rnd(N, D, H, W, ci2).bfloat16() if ci2 else None
    w = (rnd(3, 3, 3, ci1 + ci2, co) / (27 * (ci1 + ci2)) ** 0.5).bfloat16()
    b = rnd(co) * 0.1
    kw = dict(x2=x2, in1_slope=sl1, in2_slope=sl2, out_slope=slo, stats=stats,
              out_planes=(lo, hi), **aff)
    got, ref = conv_stage(x1, w, b, **kw), conv_stage_ref(x1, w, b, **kw)
    if stats:
        torch.cuda.synchronize()
        return stage_errors(torch, got, ref, key)
    return close(got, ref)


def sharded_phases(torch, np, case_dir: Path, root: Path, tmp: Path, layers,
                   pair_dirs: Sequence[Path]) -> dict:
    """Phase 14: the parallel paths on the card (one card: every multi-rank
    run is gloo ranks sharing cuda:0, so times are overheads, not scaling).

    14a: one NCCL rank: the mirror-sharded and the X-sharded two-model
    fullconv of ``case_dir`` against the unsharded engine (model 1's
    probabilities bit-equal; model 2's within 4x the unsharded engine's own
    run-to-run spread, from conv_stage's atomic sums; labels equal but
    where that change of model 2 can reach a threshold).
    14b: two gloo ranks: the mirror-sharded two-model fullconv (labels on
    >= 0.9999 of voxels).  14c: two gloo ranks: the X-sharded forward of
    each model against the unsharded one (labels on >= 0.999 of voxels for
    model 1's trained fold, 0.99 for model 2's random one; against the f32
    forward of the same weights, an error at most twice the unsharded bf16
    forward's; peak memory per rank, halo and statistics bytes per forward,
    launches per rank against the dispatch), and the time of one halo
    exchange and one statistics all-reduce.  14d:
    two gloo ranks: the data-parallel MODEL1_BN step at 128^3 x 2 against
    the single-process step (loss rtol 1e-3).  14e: the patch runner on the
    case, and ``dryrun_multichip(2)`` on the card.  14f: the engine's entry
    points as ``segment --dp-devices 2`` runs them on each rank
    (``cli._segment_rank``): ``--spatial-shard`` on ``case_dir`` and
    ``--batch-cases 2`` over the two cases of ``pair_dirs``; launches per
    rank against the dispatch, only rank 0 writes, its files' labels
    against the unsharded engine's.  14g: every kernel against its plain
    version at every launch key the ranks of 14b-14f recorded (the slab
    shapes with their halo planes, conv_stage's windows, the N = 1 training
    and patch shapes)."""
    from braintpu_torch.graft_entry import dryrun_multichip
    from braintpu_torch.io.brats import find_cases
    from braintpu_torch.models.unet3d import MODEL1_BN
    from braintpu_torch.parallel import launch
    from braintpu_torch.parallel.launch import free_tcp_init, spawn
    from braintpu_torch.parallel.scenarios import run, two_model_case

    tap_layers, stage_layers, up_layers, m2 = layers
    engine_argv = ["--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
                   "--random-weights"]
    argv = ["--input", str(case_dir), "--output", str(tmp / "out14"), *engine_argv]
    pair_root = tmp / "pair14"
    pair_root.mkdir()
    for d in pair_dirs:  # two cases of one bucket
        c = find_cases(d)[0]
        (pair_root / c.case_id).symlink_to(c.folder, target_is_directory=True)
    two = ["cuda:0", "cuda:0"]
    out = {}

    def max_diff(a, b):
        return float(np.abs(a - b).max())

    with phase("14a sharded two-model fullconv on one NCCL rank (seed 200)"):
        torch.cuda.empty_cache()
        launch.init_rank("cuda:0", "nccl", free_tcp_init(), rank=0, world_size=1)
        try:
            r = two_model_case(argv, str(case_dir), paths=("plain", "plain#2", "mirror",
                                                            "spatial"))
        finally:
            torch.distributed.destroy_process_group()
        plain = r["plain"]
        spread = [max_diff(a, b) for a, b in zip(plain["probs"], r["plain#2"]["probs"])]
        rep = {"bucket": r["bucket"], "route": r["route"],
               "plain_s": plain["seconds"], "plain_again_s": r["plain#2"]["seconds"],
               "model2_run_to_run_max_abs": spread[1]}
        mean = (plain["probs"][0] + plain["probs"][1]) / 2  # the softmax ensemble's map
        for path in ("mirror", "spatial"):
            d = [max_diff(a, b) for a, b in zip(r[path]["probs"], plain["probs"])]
            # model 2's statistics are atomic sums, so its maps move between
            # runs (by up to d[1] here) and so may a label, but only where the
            # two models' mean lies within d[1] / 2 of a region's threshold
            differ = int((r[path]["labels"] != plain["labels"]).sum())
            reach = int((np.abs(mean - 0.5) <= d[1] / 2 + 1e-6).any(axis=-1).sum())
            rep[path] = {"s": r[path]["seconds"], "labels_differ": differ,
                         "voxels_within_reach": reach,
                         "model1_max_abs": d[0], "model2_max_abs": d[1],
                         "launches": r[path]["launches"],
                         "max_memory_allocated_bytes": r[path]["max_memory_allocated_bytes"]}
            if differ > reach or d[0] != 0.0 or d[1] > max(4 * spread[1], 0.0):
                raise AssertionError(f"14a {path} vs unsharded: {differ} labels differ ({reach} "
                                     f"voxels within reach of model 2's change), model 1 "
                                     f"{d[0]} (must be 0), model 2 {d[1]} (run-to-run "
                                     f"{spread[1]})")
        rep["plain_launches"] = plain["launches"]
        print(json.dumps({"sharded_one_rank": rep}), flush=True)
        out["14a"] = rep
        base_labels, base_probs, bucket = plain["labels"], plain["probs"], r["bucket"]
        del r, plain
        torch.cuda.empty_cache()

    with phase("14b-14e two gloo ranks on the card, started once: every scenario"):
        # one start of the two rank processes (each start takes seconds)
        one = ["--folds", "1", "--no-tta"]
        plane = (1, bucket[0] // 2, bucket[1], bucket[2], 64)
        specs = [("m", "two_model_case", dict(argv=argv, case_dir=str(case_dir),
                                              paths=("mirror", "mirror#2")))]
        specs += [(m, "two_model_case", dict(argv=argv + ["--models", m] + one,
                                             case_dir=str(case_dir),
                                             paths=("plain", "spatial", "plain#2", "spatial#2",
                                                    "f32"),
                                             return_probs=False,
                                             diffs=(("spatial#2", "plain#2"),
                                                    ("plain", "plain#2"), ("spatial#2", "f32"),
                                                    ("plain#2", "f32"))))
                  for m in ("model1", "model2")]
        specs += [("t", "collective_times", dict(plane=plane, stats=(1, 64))),
                  ("dp", "train", dict(cfg=MODEL1_BN, seed=0,
                                       batches=("synth", 3, (2, 128, 128, 128), 0), data=2,
                                       model=1, lr=1e-2, params_out=False, timed_from=1)),
                  ("p", "patch_runner_case", dict(argv=argv + ["--models", "model1", "--folds",
                                                               "1"],
                                                  case_dir=str(case_dir), batch_size=2)),
                  ("seg_spatial", "segment", dict(argv=["--input", str(case_dir), *engine_argv,
                                                        "--spatial-shard"],
                                                  out=str(tmp / "seg14_spatial"))),
                  ("seg_batched", "segment", dict(argv=["--input", str(pair_root), *engine_argv,
                                                        "--batch-cases", "2"],
                                                  out=str(tmp / "seg14_batched")))]
        ranks = spawn(run, 2, devices=two, args=(specs, True), timeout_s=900)

    with phase("14b mirror-sharded two-model fullconv (two gloo ranks)"):
        # the ranks are new processes: the second run is the one without first-use costs
        got = ranks[0]["m"]["mirror#2"]
        agree = float((got["labels"] == base_labels).mean())
        want = {"conv3d_tap_merged": 4 * 2 * len(tap_layers(bucket)),
                "conv_stage": 4 * 2 * len(stage_layers(bucket)),
                "upconv2x": 4 * 2 * (len(up_layers(MODEL1_BN, bucket))
                                     + len(up_layers(m2, bucket)))}
        rep = {"route": ranks[0]["m"]["route"], "label_agreement": agree,
               "model1_max_abs": max_diff(got["probs"][0], base_probs[0]),
               "model2_max_abs": max_diff(got["probs"][1], base_probs[1]),
               "s_per_rank": [rk["m"]["mirror#2"]["seconds"] for rk in ranks],
               "first_run_s_per_rank": [rk["m"]["mirror"]["seconds"] for rk in ranks],
               "unsharded_s": out["14a"]["plain_again_s"],
               "launches_per_rank": [rk["m"]["mirror#2"]["launches"] for rk in ranks],
               "launches_formula_per_rank": want,
               "traffic_per_rank": [rk["m"]["mirror#2"]["traffic"] for rk in ranks],
               "max_memory_allocated_bytes_per_rank": [
                   rk["m"]["mirror#2"]["max_memory_allocated_bytes"] for rk in ranks]}
        print(json.dumps({"mirror_two_ranks": rep}), flush=True)
        out["14b"] = rep
        if agree < 0.9999 or any(lk != want for lk in rep["launches_per_rank"]):
            raise AssertionError(f"14b: labels {agree}, launches {rep['launches_per_rank']} "
                                 f"!= {want}")

    with phase("14c X-sharded forward of each model (two gloo ranks)"):
        rep = {"collective_times": ranks[0]["t"], "halo_plane_shape": list(plane)}
        for m, cfg in (("model1", MODEL1_BN), ("model2", m2)):
            want = {"conv3d_tap_merged": len(tap_layers(bucket)) if m == "model1" else 0,
                    "conv_stage": len(stage_layers(bucket)) if m == "model2" else 0,
                    "upconv2x": len(up_layers(cfg, bucket))}
            per_rank = []
            for rk in ranks:
                # the second run of each: the first pays the new process's first use
                sp, pl = rk[m]["spatial#2"], rk[m]["plain#2"]
                ma = {k: v[0] for k, v in rk[m]["max_abs"].items()}
                by_plane = rk[m]["max_abs_by_plane"]["spatial#2 vs plain#2"][0]
                half = len(by_plane) // 2  # the slab boundary: planes half - 1 | half
                per_rank.append({
                    "label_agreement": float((sp["labels"] == pl["labels"]).mean()),
                    "probs_max_abs": ma["spatial#2 vs plain#2"],
                    "unsharded_run_to_run_max_abs": ma["plain vs plain#2"],
                    "f32_max_abs": ma["spatial#2 vs f32"],
                    "unsharded_f32_max_abs": ma["plain#2 vs f32"],
                    "probs_max_abs_boundary_planes": max(by_plane[half - 2:half + 2]),
                    "probs_max_abs_other_planes": max(by_plane[:half - 2] + by_plane[half + 2:]),
                    "spatial_s": sp["seconds"], "unsharded_s": pl["seconds"],
                    "first_run_spatial_s": rk[m]["spatial"]["seconds"],
                    "first_run_unsharded_s": rk[m]["plain"]["seconds"],
                    "peak_bytes": sp["max_memory_allocated_bytes"],
                    "unsharded_peak_bytes": pl["max_memory_allocated_bytes"],
                    "traffic_per_forward": sp["traffic"], "launches": sp["launches"]})
            # bf16: a slab's convs run at other shapes than the whole volume's,
            # so a few outputs round the other way; model 2's random weights
            # leave many voxels near 0.5 (the same check on the CPU at 64x32x32: 0.9985)
            floor = 0.999 if m == "model1" else 0.99
            # probabilities: against the f32 forward of the same weights (the
            # exact function both bf16 forwards approximate), the X-sharded
            # forward's largest error at most twice the unsharded one's: bf16
            # convs at a slab's shapes round differently, a wrong halo or
            # statistic would be an error of its own
            bound = [2 * p["unsharded_f32_max_abs"] for p in per_rank]
            rep[m] = {"per_rank": per_rank, "launches_formula": want, "label_floor": floor,
                      "f32_error_bound": bound}
            bad = [p for p, lim in zip(per_rank, bound) if p["launches"] != want
                   or p["label_agreement"] < floor or not p["f32_max_abs"] <= lim]
            if bad:
                raise AssertionError(f"14c {m}: {bad} (launches want {want}, labels >= {floor}, "
                                     f"error against f32 within {bound})")
        print(json.dumps({"spatial_two_ranks": rep}), flush=True)
        out["14c"] = rep

    with phase("14d data-parallel MODEL1_BN step at 128^3 x 2 (two gloo ranks)"):
        r = ranks[0]["dp"]
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(r["sharded"],
                                                                          r["single"])]
        rep = {"losses": [a["loss"] for a in r["sharded"]],
               "single_losses": [b["loss"] for b in r["single"]], "loss_rel_err": rel,
               "grad_norms": [a["grad_norm"] for a in r["sharded"]],
               "single_grad_norms": [b["grad_norm"] for b in r["single"]],
               "s_per_step": r["seconds_per_step"], "steps_timed": 2,
               "launches_per_rank_timed": [rk["dp"]["launches"] for rk in ranks],
               "traffic_per_rank_timed": [rk["dp"]["traffic"] for rk in ranks],
               "max_memory_allocated_bytes": r["max_memory_allocated_bytes"]}
        print(json.dumps({"dp_train_two_ranks": rep}), flush=True)
        out["14d"] = rep
        if max(rel) > 1e-3 or any(lk["conv3d_tap_merged"] == 0
                                  for lk in rep["launches_per_rank_timed"]):
            raise AssertionError(f"14d: loss rel err {rel} > 1e-3 or no tap launch: {rep}")

    with phase("14e patch runner on the case (two gloo ranks); dryrun_multichip(2) on the card"):
        pr = ranks[0]["p"]
        pr_launches = [rk["p"]["launches"] for rk in ranks]
        dry = dryrun_multichip(2)
        rep = {"patch_runner": {k: pr[k] for k in ("shape", "max_abs_diff", "label_agreement",
                                                   "seconds")},
               "patch_runner_launches_per_rank": pr_launches, "dryrun": dry}
        print(json.dumps({"patch_runner_and_dryrun": rep}), flush=True)
        out["14e"] = rep
        if pr["label_agreement"] < 0.999 or any(
                lk["conv3d_tap_merged"] == 0 or lk["upconv2x"] == 0
                for lk in rep["patch_runner_launches_per_rank"]):
            raise AssertionError(f"14e patch runner: {rep}")
        if not dry["line"].startswith("dryrun_multichip OK"):
            raise AssertionError(f"14e dryrun: {dry}")

    with phase("14f segment --dp-devices 2 rank bodies: --spatial-shard (seed 200), "
               "--batch-cases 2 (seeds 50, 55)"):
        rep = {}
        pair_bucket = tuple(bucket_of(pair_dirs[0])[1])
        # 2 folds x 8 mirrors per model on each rank: the X-sharded forwards of
        # the one case, or the rank's one row of the batch of two
        for key, b, floor in (("seg_spatial", bucket, 0.99),
                              ("seg_batched", pair_bucket, 0.9999)):
            r0 = ranks[0][key]
            want = {"conv3d_tap_merged": 16 * len(tap_layers(b)),
                    "conv_stage": 16 * len(stage_layers(b)),
                    "upconv2x": 16 * (len(up_layers(MODEL1_BN, b)) + len(up_layers(m2, b)))}
            rep[key] = {"bucket": list(b), "s_per_rank": [rk[key]["seconds"] for rk in ranks],
                        "unsharded_s": r0["unsharded_s"],
                        "launches_per_rank": [rk[key]["launches"] for rk in ranks],
                        "launches_formula_per_rank": want,
                        "written_per_rank": [rk[key]["written"] for rk in ranks],
                        "label_agreement": r0["label_agreement"], "label_floor": floor,
                        "max_memory_allocated_bytes_per_rank": [
                            rk[key]["max_memory_allocated_bytes"] for rk in ranks],
                        "traffic_per_rank": [rk[key]["traffic"] for rk in ranks]}
            files = sorted(f"{c}.nii.gz" for c in r0["label_agreement"])
            if (r0["written"] != files or any(rk[key]["written"] for rk in ranks[1:])
                    or any(rk[key]["launches"] != want for rk in ranks)
                    or min(r0["label_agreement"].values()) < floor
                    or r0["batched"] != (key == "seg_batched")):
                raise AssertionError(f"14f {key}: {rep[key]} (rank 0 writes {files})")
        print(json.dumps({"segment_rank_bodies": rep}), flush=True)
        out["14f"] = rep

    with phase("14g every kernel vs plain at the sharded paths' launch keys"):
        keys = {}  # the ranks' keys, each once, in order
        for rk in ranks:
            for name, ks in rk["launch_keys"].items():
                keys.setdefault(name, {}).update(dict.fromkeys(tuple(k) for k in ks))
        keys = {name: list(ks) for name, ks in keys.items()}
        del ranks
        rep = {}
        for name in ("conv3d_tap_merged", "conv_stage", "upconv2x"):
            if not keys.get(name):
                raise AssertionError(f"14g: the sharded ranks recorded no launch of {name}")
            errs = [check_launch_key(torch, name, k, seed=300 + i)
                    for i, k in enumerate(keys[name])]
            torch.cuda.empty_cache()
            rep[name] = {"keys": len(errs), "max_abs_err": max(e["max_abs_err"] for e in errs),
                         "launch_keys": [list(k) for k in keys[name]]}
            if name == "conv_stage":
                rep[name]["windowed_keys"] = sum(1 for k in keys[name] if (k[13], k[14])
                                                 != (0, k[1]))
        print(json.dumps({"sharded_launch_keys": rep}), flush=True)
        out["14g"] = rep
    return out


def closing_surface(torch, np, case_dir: Path, seg_path: Path) -> dict:
    """Phase 15: the reference's last public functions on the card, on seed
    200's case and the trained model-1 folds.

    ``confusion_counts``, ``evaluate_pair`` and ``evaluate_segmentation`` on
    card tensors of ``seg_path`` (a BraTS-2025 label map of the case) against
    the generator's ground truth, equal to the host's bincount counts;
    ``stack_folds`` of the loaded folds on the card, equal to the host stack;
    ``param_count`` of each fold, equal to the npz's own size; and
    ``estimate_activation_bytes(MODEL1_BN)`` beside the peak memory of one
    bf16 forward at its patch (printed, not gated)."""
    from braintpu_torch.ckpt.npz import load_pytree_npz, params_from_jax
    from braintpu_torch.infer.engine import ModelBundle
    from braintpu_torch.infer.sliding_window import stack_folds
    from braintpu_torch.io import nifti
    from braintpu_torch.io.brats import find_cases
    from braintpu_torch.labels.convert import normalize_to_brats2025
    from braintpu_torch.metrics.segmentation import (COMPOUND_REGIONS, _region_counts_np,
                                                     confusion_counts, evaluate_pair,
                                                     evaluate_segmentation, metrics_from_counts)
    from braintpu_torch.models.unet3d import (MODEL1_BN, apply_unet, estimate_activation_bytes,
                                              param_count)

    cuda = torch.device("cuda")
    case = find_cases(case_dir)[0]
    label = lambda p: normalize_to_brats2025(  # noqa: E731
        nifti.load(p).get_fdata(dtype="float32")).astype(np.int32)
    pred, gt = label(seg_path), label(case.seg_path)
    regions = ((1,), (2,), (3,)) + tuple(COMPOUND_REGIONS.values())
    host = _region_counts_np(pred, gt, regions)
    pred_d, gt_d = torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda)
    card = confusion_counts(pred_d, gt_d, regions)
    counts_equal = card.device.type == "cuda" and np.array_equal(card.cpu().numpy(), host)
    pairs_equal = all(evaluate_pair(pred_d, gt_d, lab).as_dict()
                      == metrics_from_counts(*host[i].tolist()).as_dict()
                      for i, lab in enumerate((1, 2, 3)))
    eval_equal = evaluate_segmentation(pred_d, gt_d) == evaluate_segmentation(pred, gt)

    paths = [CKPTS / "model1" / f"fold_{f}.npz" for f in (0, 1)]
    trees = [load_pytree_npz(p) for p in paths]
    npz_sizes = [sum(int(a.size) for a in np.load(p).values()) for p in paths]
    folds = [params_from_jax(t, MODEL1_BN) for t in trees]
    counts = [param_count(f) for f in folds]
    stacked_host = stack_folds(folds)

    def on_card(t):
        if isinstance(t, dict):
            return {k: on_card(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [on_card(v) for v in t]
        return t.to(cuda)

    stacked_card = stack_folds([on_card(f) for f in folds])
    leaves = []

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            leaves.append(b.device.type == "cuda" and a.shape[0] == 2
                          and torch.equal(a, b.cpu()))

    walk(stacked_host, stacked_card)
    del stacked_card
    bundle = ModelBundle.from_folds(MODEL1_BN, folds[:1]).to(cuda)
    x = torch.randn((1, *MODEL1_BN.patch_size, MODEL1_BN.in_channels), device=cuda,
                    generator=torch.Generator(device="cuda").manual_seed(15))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        logits = apply_unet(bundle.fold_params[0], x, MODEL1_BN, folded=bundle.folded)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rec = {
        "case": "BraTS-SYN-00200-000 240x240x155", "labels": seg_path.name,
        "confusion_counts_card_equal_host": counts_equal,
        "evaluate_pair_card_equal_host": pairs_equal,
        "evaluate_segmentation_card_equal_host": eval_equal,
        "counts": {str(r): c for r, c in zip(regions, host.tolist())},
        "stack_folds_leaves": len(leaves), "stack_folds_card_equal_host": all(leaves),
        "param_count_per_fold": counts, "npz_values_per_fold": npz_sizes,
        "estimate_activation_bytes_model1": estimate_activation_bytes(MODEL1_BN),
        "forward_peak_bytes_above_inputs": peak - before, "forward_peak_bytes": peak,
        "forward": f"MODEL1_BN fold 0, folded, bf16, N=1 at {MODEL1_BN.patch_size}",
        "logits_finite": bool(torch.isfinite(logits).all()),
    }
    print(json.dumps({"closing_surface": rec}), flush=True)
    bad = [k for k in ("confusion_counts_card_equal_host", "evaluate_pair_card_equal_host",
                       "evaluate_segmentation_card_equal_host", "stack_folds_card_equal_host",
                       "logits_finite") if not rec[k]]
    if bad or not leaves or counts != npz_sizes:
        raise AssertionError(f"closing surface: {bad}; param_count {counts} against the npz "
                             f"sizes {npz_sizes}; {len(leaves)} stacked leaves")
    return rec


#: the conv_impl values phase 16 runs: the default, the tap kernel wherever
#: it takes a conv, and the library everywhere ("decomp2d" and "merged2d"
#: take the library's route as "xla3d" does)
CONV_IMPLS = ("auto", "pallas", "xla3d")


def conv_impl_phase(torch, case_dir: Path, root: Path, tmp: Path, layers) -> dict:
    """Phase 16: ``UNetConfig.conv_impl`` on the card.

    The CLI's two-model fullconv engine (8-flip TTA, ``--folds 2``: model 1's
    trained folds from ``root``, model 2 from ``init_params`` seeds 1000 and
    1001) on ``case_dir`` (seed 200 at 240x240x155) under each of
    :data:`CONV_IMPLS`, the value set on both bundles' configs.  Per value:
    one case counts each kernel's launches and records their launch keys,
    then s/case is the min and median of 3 after that warm-up, with the peak
    memory, and each model's probability maps alone (min of 3); each kernel
    that launched is held against its plain version at every launch key (as
    phase 14g); the labels are held to "auto"'s.  It
    fails when "auto"'s launches differ from phase 8's formula (``layers``:
    the tap / stage / up-conv layer functions of ``main``), when a value's
    launches differ from ``conv_routes`` x 16 forwards per model (so
    "xla3d" launches no tap kernel and no ``conv_stage``, and "pallas" no
    ``conv_stage`` and a tap kernel at every admitted conv), when the labels
    agree on less than 0.999 of the voxels, or when an unknown value does
    not raise the reference's ValueError."""
    import numpy as np

    from braintpu_torch.cli import build_parser, load_engine
    from braintpu_torch.infer.fullconv import predict_probs_fullconv
    from braintpu_torch.io.brats import find_cases, load_case_volumes
    from braintpu_torch.models.unet3d import conv_routes
    from braintpu_torch.pre.preprocess import preprocess_case
    from braintpu_torch.ops import _build
    from braintpu_torch.ops.conv3d import conv3d_tap_merged
    from braintpu_torch.ops.stage import conv_stage
    from braintpu_torch.ops.upconv import upconv2x

    tap_layers, stage_layers, up_layers = layers
    kernels = {"conv3d_tap_merged": conv3d_tap_merged, "conv_stage": conv_stage,
               "upconv2x": upconv2x}
    base = load_engine(build_parser().parse_args(
        ["segment", "--input", str(case_dir), "--output", str(tmp / "out16"),
         "--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
         "--random-weights"]))
    case = find_cases(case_dir)[0]
    data, _, _ = load_case_volumes(case)
    vol = preprocess_case(data, patch_size=(32,) * 3, pad_multiple=32,
                          device=torch.device("cuda")).data

    def engine_for(impl):
        return dataclasses.replace(base, models=[
            dataclasses.replace(m, cfg=dataclasses.replace(m.cfg, conv_impl=impl))
            for m in base.models])

    out, labels, checked = {}, {}, {}
    for impl in CONV_IMPLS:
        eng = engine_for(impl)
        for fn in kernels.values():
            fn.launches = 0
        _build.launch_keys = {}
        try:
            seg, info = eng.predict_case(case)  # warm-up: launches and keys of one case
            torch.cuda.synchronize()
        finally:
            keys, _build.launch_keys = _build.launch_keys, None
        launches = {name: fn.launches for name, fn in kernels.items()}
        bucket = tuple(info["bucket_shape"])
        want = {"conv3d_tap_merged": 0, "conv_stage": 0, "upconv2x": 0}
        for m in eng.models:  # 2 folds x 8 mirrors, one launch per layer each
            routes = conv_routes(m.cfg, bucket)
            want["conv3d_tap_merged"] += 16 * routes.count("kernel")
            want["conv_stage"] += 16 * routes.count("stage")
            want["upconv2x"] += 16 * len(up_layers(m.cfg, bucket))
        if impl == "auto":
            formula = {"conv3d_tap_merged": 16 * len(tap_layers(bucket)),
                       "conv_stage": 16 * len(stage_layers(bucket)),
                       "upconv2x": want["upconv2x"]}
            if want != formula:
                raise AssertionError(f"16 auto: conv_routes {want} != phase 8's formula {formula}")
        if launches != want:
            raise AssertionError(f"16 conv_impl={impl!r}: launches per case {launches} != {want}")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.predict_case(case)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        forwards = {}  # each model's 2 folds x 8 mirrors alone, min of 3
        for m in eng.models:
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                with torch.inference_mode():
                    predict_probs_fullconv(m.fold_params, vol, m.cfg, tta=True, folded=m.folded)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            forwards[m.name] = min(ts)
        labels[impl] = seg
        agree = float(np.mean(seg == labels["auto"]))
        errs = {}
        for name, ks in sorted(keys.items()):
            res = []
            for i, k in enumerate(sorted(ks, key=repr)):
                if k not in checked:
                    checked[k] = check_launch_key(torch, name, k, seed=400 + len(checked))
                res.append(checked[k])
            torch.cuda.empty_cache()
            errs[name] = {"launch_keys": len(res),
                          "max_abs_err": max(r["max_abs_err"] for r in res)}
        rec = {"conv_impl": impl, "case": case.case_id, "bucket": list(bucket),
               "models": "model1 (2 trained folds) + model2 (init_params seeds 1000, 1001)",
               "s_per_case_min": min(times), "s_per_case_median": statistics.median(times),
               "s_per_case": times, "launches_per_case": launches,
               "max_memory_allocated_bytes": peak, "label_agreement_with_auto": agree,
               "s_probability_maps_per_model_min": forwards,
               "kernels_vs_plain_at_launch_keys": errs}
        print(json.dumps({"conv_impl_on_card": rec}), flush=True)
        out[impl] = rec
        if agree < 0.999:
            raise AssertionError(f"16 conv_impl={impl!r}: labels agree with auto on {agree}")
        del eng
        torch.cuda.empty_cache()
    try:
        engine_for("tap").predict_case(case)
    except ValueError as e:
        if "unknown conv_impl 'tap'" not in str(e):
            raise
        out["unknown_value_raises"] = str(e)
    else:
        raise AssertionError("16: conv_impl='tap' did not raise")
    print(json.dumps({"conv_impl_unknown_value": out["unknown_value_raises"]}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", metavar="DIR",
                    help="write the profiled case's Chrome trace to DIR/trace.json.gz")
    ap.add_argument("--only-conv-impl", action="store_true",
                    help="run phases 1, 2 and 16 (conv_impl on the card) alone")
    args = ap.parse_args()
    t_start = time.perf_counter()
    # the chat phases take the assistant's offline path: no LLM key, so no
    # request leaves the machine
    os.environ["GEMINI_API_KEY"] = ""
    import numpy as np
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

    from braintpu_torch import native
    from braintpu_torch.cli import build_parser, load_engine
    from braintpu_torch.features import run_all_steps
    from braintpu_torch.features.devstats import GROUPS, MEASURED_WIN_GROUPS
    from braintpu_torch.infer import engine as engine_mod
    from braintpu_torch.infer.engine import ModelBundle
    from braintpu_torch.infer.gaussian import patch_grid
    from braintpu_torch.infer.sliding_window import default_mirror_chunk, region_probs_to_labels
    from braintpu_torch.io import nifti
    from braintpu_torch.io.brats import (CasePrefetcher, find_cases, load_case_volumes,
                                         load_case_volumes_native, load_case_volumes_python)
    from braintpu_torch.labels.convert import internal_to_brats2025, normalize_to_brats2025
    from braintpu_torch.metrics.segmentation import evaluate_segmentation
    from braintpu_torch.models import unet3d
    from braintpu_torch.models.unet3d import (MODEL1_BN, MODEL2_GN_LARGE, choose_impl,
                                              choose_stage_impl, conv_layers, deferred_layers,
                                              forward_flops, init_params, upconv_layers,
                                              upconv_supported)
    from braintpu_torch.ops import _build
    from braintpu_torch.ops.conv3d import conv3d_tap_merged
    from braintpu_torch.ops.int8_probe import int8_matmul
    from braintpu_torch.ops.stage import conv_stage, conv_stage_ref
    from braintpu_torch.ops.upconv import upconv2x
    from braintpu_torch.pipeline import Pipeline, PipelineConfig
    from braintpu_torch.pre.preprocess import preprocess_case
    from braintpu_torch.report import SlotValidator
    from braintpu_torch.serve import make_server
    from braintpu_torch.tools import probe
    from braintpu_torch.cli import main as cli_main
    from braintpu_torch.ckpt.npz import (load_pytree_npz, params_from_jax, params_to_jax,
                                         save_pytree_npz)
    from braintpu_torch.train.data import PatchSampler
    from braintpu_torch.train.synthetic import write_synth_case, write_synth_dataset
    from braintpu_torch.train.trainer import TrainConfig, create_train_state, fit

    # the segmentation kernels; int8_matmul (the probe's) is counted apart
    kernels = {"conv3d_tap_merged": conv3d_tap_merged, "conv_stage": conv_stage,
               "upconv2x": upconv2x}

    def reset_counts():
        for fn in (*kernels.values(), int8_matmul):
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def tap_layers(bucket, batch=1):
        return [(s, co) for s, st, co in conv_layers(MODEL1_BN, bucket, batch)
                if choose_impl(s, (3, 3, 3), st, co, MODEL1_BN.compute_dtype) == "kernel"]

    def stage_layers(bucket, batch=1):
        return [(s, co, c2) for s, st, co, c2 in deferred_layers(MODEL2_GN_LARGE, bucket, batch)
                if choose_stage_impl(s, (3, 3, 3), st, co, c2, MODEL2_GN_LARGE.compute_dtype)
                == "kernel"]

    def up_layers(cfg, bucket, batch=1):
        return [(s, co) for s, co in upconv_layers(cfg, bucket, batch) if upconv_supported(s, co)]

    # sliding mode: one 128^3 patch per forward, the mirror copies batched
    # along N (8 for model 1, 4 for model 2)
    patch = tuple(MODEL1_BN.patch_size)
    chunk = {MODEL1_BN: default_mirror_chunk(MODEL1_BN),
             MODEL2_GN_LARGE: default_mirror_chunk(MODEL2_GN_LARGE)}

    with phase("2 build"):
        print(f"sources: {_build.build_all()} -> {_build.BUILD_DIR.relative_to(ROOT)}")
        print(f"wgmma instructions in the SASS: {sass_check(_build)}")
        # the native host library (g++, zlib): it must build, unless the
        # machine lacks g++ or zlib.h, where the build's message is printed
        # and the host takes its Python routes
        t0 = time.perf_counter()
        if native.native_available():
            print(f"native host library: {native.library_path().relative_to(ROOT)} "
                  f"({time.perf_counter() - t0:.2f}s)")
        else:
            print(f"native host library did not build:\n{native.build_error()}")
            if toolchain_present():
                raise AssertionError("g++ and zlib.h are present, yet the native library "
                                     "did not build")

    if args.only_conv_impl:
        with tempfile.TemporaryDirectory(prefix="braintpu_torch_smoke_") as tmp:
            tmp = Path(tmp)
            case = write_synth_case(tmp / "flag", "BraTS-SYN-00200-000", seed=200,
                                    shape=(240, 240, 155))
            root = tmp / "ckpt"
            (root / "model1").mkdir(parents=True)
            for f in (0, 1):
                (root / "model1" / f"fold_{f}.npz").symlink_to(CKPTS / "model1" / f"fold_{f}.npz")
            with phase("16 conv_impl on the card (seed 200, 240x240x155)"):
                conv_impl_phase(torch, case, root, tmp, (tap_layers, stage_layers, up_layers))
        print(f"# total wall: {time.perf_counter() - t_start:.1f}s")
        print(nvidia_smi())
        return 0

    with tempfile.TemporaryDirectory(prefix="braintpu_torch_smoke_") as tmp:
        tmp = Path(tmp)
        with phase("3 cases"):
            # each case from its own seed, written on a thread of its own
            big = (240, 240, 155)
            with ThreadPoolExecutor(max_workers=5) as pool:
                futs = [pool.submit(write_synth_case, tmp / d, f"BraTS-SYN-{seed:05d}-000",
                                    seed=seed, **kw)
                        for d, seed, kw in (("in", 200, {}), ("in", 50, {"shape": big}),
                                            ("flag", 200, {"shape": big}),
                                            ("third", 51, {"shape": big}),
                                            ("pair", 55, {"shape": big}))]
                # phase 8d's third case is seed 51; phase 12e's seed 55 shares
                # seed 50's fullconv bucket (seeds 50, 51 and 200 fall in three)
                anchor, brats_size, flagship, third, pair = [f.result() for f in futs]
            buckets = {}
            for name, case in (("anchor", anchor), ("brats_size", brats_size),
                               ("flagship_geometry", flagship)):
                crop, buckets[name] = bucket_of(case)
                print(f"{name}: crop {crop} -> bucket {buckets[name]}")
            main_bucket = buckets["brats_size"]

        results = {name: [] for name in kernels}  # per-shape checks, all buckets
        with phase("4 kernels vs plain"):
            print("# cut: each plain version is timed over 5 calls after 1 warm-up (20 after 3 "
                  "before), for the smoke's time")
            # every fullconv bucket at N = 1, and the sliding patch at N = 8 / 4
            fc = [(b, 1) for b in buckets.values()]
            sources = {
                "conv3d_tap_merged": [(tap_layers, (b, n)) for b, n in
                                      fc + [(patch, chunk[MODEL1_BN])]],
                "conv_stage": [(stage_layers, (b, n)) for b, n in
                               fc + [(patch, chunk[MODEL2_GN_LARGE])]],
                "upconv2x": [(lambda b, n, c=c: up_layers(c, b, n), (b, n))
                             for b, n in fc for c in (MODEL1_BN, MODEL2_GN_LARGE)]
                            + [(lambda b, n, c=c: up_layers(c, b, n), (patch, chunk[c]))
                               for c in (MODEL1_BN, MODEL2_GN_LARGE)],
            }
            checks = {"conv3d_tap_merged": lambda k, i: check_kernel(torch, *k, seed=i),
                      "conv_stage": lambda k, i: check_stage(torch, *k, seed=100 + i),
                      "upconv2x": lambda k, i: check_upconv(torch, *k, seed=200 + i)}
            for name, src in sources.items():
                shapes = []
                for layers, layer_args in src:
                    for k in layers(*layer_args):
                        if k not in shapes:
                            shapes.append(k)
                for i, k in enumerate(shapes):
                    r = checks[name](k, i)
                    r["buckets"] = [list(b) for b in sorted({tuple(b) for layers, (b, n) in src
                                                             if n == 1 and k in layers(b, n)})]
                    r["sliding"] = k[0][0] > 1  # a mirror chunk of the 128^3 patch
                    results[name].append(r)
                    print(json.dumps({name: r}), flush=True)
                torch.cuda.empty_cache()
            # the output-plane window of an X-sharded forward (phase 14): the
            # heaviest level-0 shape of the main bucket as a two-rank slab
            # with both halos, its own planes computed and summed
            s0, co0, c20 = max(stage_layers(main_bucket), key=lambda k: k[0][2] * k[0][3])
            slab = (s0[0], s0[1] // 2 + 2) + tuple(s0[2:])
            stage_window = check_stage_window(torch, slab, co0, c20, (1, slab[1] - 1), seed=199)
            print(json.dumps({"conv_stage_window": stage_window}), flush=True)

        with phase("4b int8_matmul vs plain (probe entry point)"):
            # the probe entry point is int8_matmul's only path: driven with
            # every count at 0, read just after
            log = tmp / "probe.jsonl"
            reset_counts()
            rc = probe.main(["int8", "--log", str(log)])
            int8_launches = int8_matmul.launches
            int8_records = [json.loads(ln) for ln in log.read_text().splitlines()]
            print(f"probe int8: rc {rc}, int8_matmul launches {int8_launches}, "
                  f"segmentation kernels {counts()}")
            if rc != 0 or int8_launches == 0 or any(counts().values()):
                raise AssertionError("the probe entry point did not run through int8_matmul alone")
            # three more shapes (probe.RAGGED_SHAPES): ragged against the
            # fast route's tile, and the byte route; cuBLASLt refuses K = 80
            # and K = 84: no library time there
            for label, M, K, N, bm, bn, bk in probe.RAGGED_SHAPES:
                r = probe.measure_int8(label, M, K, N, bm, bn, bk, seed=50 + M + K,
                                       library=label == "ragged-valid")
                print(json.dumps(r), flush=True)
                int8_records.append(r)
            bad = [r["probe"] for r in int8_records if not r["ok"] or r["max_abs_err"] != 0]
            if bad:
                raise AssertionError(f"int8_matmul is not bit-equal to its plain version: {bad}")
            torch.cuda.empty_cache()

        with phase("4c decode: native vs Python (seed 50, 240x240x155)"):
            case50 = find_cases(brats_size)[0]
            route = load_case_volumes(case50).route
            dec = {"case": "BraTS-SYN-00050-000 240x240x155, 4 modalities", "route": route}
            if native.native_available():
                if route != "native":
                    raise AssertionError(f"the case loader took the {route} route")
                nat, py = load_case_volumes_native(case50), load_case_volumes_python(case50)
                same = (nat[0].dtype == py[0].dtype == np.float32
                        and np.array_equal(nat[0].view(np.uint32), py[0].view(np.uint32))
                        and np.array_equal(nat[1], py[1]) and tuple(nat[2]) == tuple(py[2]))
                if not same:
                    raise AssertionError("native decode is not bit-equal to the Python decode")
                secs = {"native": [], "python": []}
                for which in ("native", "python", "python", "native", "native", "python"):
                    load = load_case_volumes_native if which == "native" else \
                        load_case_volumes_python
                    t0 = time.perf_counter()
                    load(case50)
                    secs[which].append(time.perf_counter() - t0)
                dec.update({"bit_equal": same, "native_s": secs["native"],
                            "python_s": secs["python"], "native_s_min": min(secs["native"]),
                            "python_s_min": min(secs["python"])})
            print(json.dumps({"decode": dec}), flush=True)

        with phase("4d RAG top-k on the card"):
            print(json.dumps({"rag_topk": check_rag_topk(torch)}), flush=True)
            torch.cuda.empty_cache()

        train_tap = []
        with phase("4e tap kernel with its gradient at the training shapes"):
            # level 1 of a 128^3 training patch at batch 2 (D = 64): each
            # model's band convs, without LeakyReLU (the norm sits between
            # the conv and the activation); forward and autograd backward
            shapes = []
            for cfg in (MODEL1_BN, MODEL2_GN_LARGE):
                for s, st, co in conv_layers(cfg, patch, 2):
                    if (choose_impl(s, (3, 3, 3), st, co, cfg.compute_dtype) == "kernel"
                            and (s, co) not in shapes):
                        shapes.append((s, co))
            for i, (s, co) in enumerate(shapes):
                r = check_tap_train(torch, s, co, seed=300 + i)
                train_tap.append(r)
                print(json.dumps({"tap_train": r}), flush=True)
            torch.cuda.empty_cache()

        # model 1 alone: the first slice's main path, now also through upconv2x
        engine_args = build_parser().parse_args(
            ["segment", "--input", str(anchor), "--output", str(tmp / "out"),
             "--checkpoints", str(CKPTS), "--models", "model1", "--folds", "2",
             "--mode", "fullconv"])
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
            print(f"{what}: launches per case {got} (forwards x the dispatch's layers: {want})")
            if got != want or not all(got[k] > 0 for k in want):
                raise AssertionError(f"{what}: kernel launches {got} != {want}")

        def model1_launches(bucket):
            return {"conv3d_tap_merged": 16 * len(tap_layers(bucket)),
                    "upconv2x": 16 * len(up_layers(MODEL1_BN, bucket))}

        def two_model_launches(bucket):
            """One fullconv case of the two-model engine: 2 folds x 8 mirrors
            through each model's kernel layers."""
            want = dict(model1_launches(bucket))
            want["conv_stage"] = 16 * len(stage_layers(bucket))
            want["upconv2x"] += 16 * len(up_layers(MODEL2_GN_LARGE, bucket))
            return want

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

        with phase("6b pipeline (main path, report half)"):
            # cli pipeline's orchestrator on the seed-200 case at 240x240x155
            # with the same model-1 engine: decode, segment, convert,
            # evaluate, the six feature steps, the governed report, the PDF
            reset_counts()
            result = Pipeline(engine, PipelineConfig(output_root=tmp / "pipeline")).run_case(
                flagship)
            torch.cuda.synchronize()
            pipe_launches = counts()
            expect_counts({k: v for k, v in pipe_launches.items() if k != "conv_stage"},
                          model1_launches(buckets["flagship_geometry"]), "pipeline, model 1")
            if pipe_launches["conv_stage"] or int8_matmul.launches:
                raise AssertionError(f"the model-1 pipeline launched conv_stage or int8_matmul: "
                                     f"{pipe_launches}, int8_matmul {int8_matmul.launches}")
            if not result.succeeded:
                raise AssertionError(f"pipeline failed: {result.summary.get('error')}")
            events = [json.loads(ln) for ln in
                      (result.output_folder / "events.jsonl").read_text().splitlines()]
            not_ok = [(e["stage"], e["status"]) for e in events if e["status"] not in ("start", "ok")]
            if not_ok:
                raise AssertionError(f"pipeline stages not ok: {not_ok}")
            dice_p = {k: v["dice"] for k, v in result.metrics["compound"].items()}
            fe = result.output_folder / "feature_extraction"
            want_files = [f"step{i}_{n}.json" for i, n in enumerate(
                ("sequence_findings", "mass_effect", "multiplicity", "morphology", "quality",
                 "normal_structures"), 1)] + ["llm_ready_summary.json", "radiology_report.txt",
                                              "radiology_report.json", "radiology_report.pdf"]
            missing = [f for f in want_files if not (fe / f).is_file()]
            violations = SlotValidator().report_violations(
                (fe / "radiology_report.txt").read_text())
            pdf_ok = (fe / "radiology_report.pdf").read_bytes()[:4] == b"%PDF"
            spans = stage_spans(events)
            seg_ok = next(e for e in events if e["stage"] == "segmenting" and e["status"] == "ok")
            print(json.dumps({"pipeline": {
                "case": "BraTS-SYN-00200-000 240x240x155",
                "models": "model1 (2 trained folds), 8-flip TTA, fullconv",
                "dice": dice_p, "launches": pipe_launches,
                "stage_seconds": {
                    "decode": seg_ok["detail"]["decode_s"],
                    "segment": seg_ok["detail"]["seconds"],
                    "convert": spans["converting"], "evaluate": spans["evaluating"],
                    "features": spans["extracting"], "report": spans["generating"],
                    "pdf": spans["exporting"],
                    "case_total": result.summary["pipeline_duration_seconds"]},
                "note": "per-stage seconds are host wall time from the events journal "
                        "(information only)"}}), flush=True)
            if min(dice_p.values()) < 0.99:
                raise AssertionError(f"pipeline Dice below 0.99: {dice_p}")
            if missing or violations or not pdf_ok:
                raise AssertionError(f"pipeline outputs: missing {missing}, report violations "
                                     f"{violations}, PDF header ok {pdf_ok}")
        del engine
        torch.cuda.empty_cache()

        def sliding_launches(cfg, bucket, folds=2):
            """Launches of one sliding case: patches x 8/N x folds forwards,
            each through the dispatch's kernel layers at (N, 128^3)."""
            n = chunk[cfg]
            forwards = len(patch_grid(bucket, patch)) * (8 // n) * folds
            if cfg is MODEL1_BN:
                return {"conv3d_tap_merged": forwards * len(tap_layers(patch, n)),
                        "upconv2x": forwards * len(up_layers(MODEL1_BN, patch, n))}
            return {"conv_stage": forwards * len(stage_layers(patch, n)),
                    "upconv2x": forwards * len(up_layers(MODEL2_GN_LARGE, patch, n))}

        with phase("6c sliding mode, model 1 (seed 200, 240x240x155)"):
            engine_s = load_engine(build_parser().parse_args(
                ["segment", "--input", str(flagship), "--output", str(tmp / "out_s"),
                 "--checkpoints", str(CKPTS), "--models", "model1", "--folds", "2",
                 "--mode", "sliding"]))
            reset_counts()
            segs, infos, dices = segment(engine_s, flagship)
            got = counts()
            sb = tuple(infos["bucket_shape"])
            want = sliding_launches(MODEL1_BN, sb)
            expect_counts({k: got[k] for k in want}, want,
                          f"sliding, model 1, {len(patch_grid(sb, patch))} patches of {sb}")
            if got["conv_stage"] or int8_matmul.launches:
                raise AssertionError(f"sliding model 1 launched conv_stage or int8_matmul: {got}")
            print(json.dumps({"sliding_model1": {
                "case": "BraTS-SYN-00200-000 240x240x155",
                "models": "model1 (2 trained folds), 8-flip TTA in chunks of 8, sliding",
                "padded_shape": sb, "patches": len(patch_grid(sb, patch)), "launches": got,
                "dice": dices, "s": infos["total_s"], "mode": infos["mode"],
                "label_agreement_with_fullconv": float((segs == segf).mean()),
                "note": "label agreement with the fullconv engine is information only"}}),
                flush=True)
            if min(dices.values()) < 0.99:
                raise AssertionError(f"sliding Dice below 0.99: {dices}")
            del engine_s
            torch.cuda.empty_cache()

        with phase("6d feature steps: native EDT vs scipy (seed 200, 240x240x155)"):
            # run_all_steps from the files (decode, context, six steps) on
            # the pipeline's segmentation, in turns: native, scipy, scipy, native
            seg_file = result.output_folder / f"{find_cases(flagship)[0].case_id}_brats.nii.gz"
            real_edt_sq = native.edt_sq

            def scipy_route(mask):
                raise IOError("the scipy route, for comparison")

            secs, summaries = {"native": [], "scipy": []}, {}
            print("# cut: the feature steps run once per route (four runs in turns before), "
                  "for the smoke's time")
            # both runs on the host route: with device groups the EDT of the
            # steps they replace would not be the host's
            os.environ["BRAINTPU_DEVICE_FEATURES"] = "0"
            for i, which in enumerate(("native", "scipy")):
                if which == "scipy" or not native.native_available():
                    native.edt_sq = scipy_route
                try:
                    t0 = time.perf_counter()
                    run_all_steps(flagship, seg_file, tmp / f"features_{i}")
                    secs[which].append(time.perf_counter() - t0)
                finally:
                    native.edt_sq = real_edt_sq
                summaries[which] = json.loads(
                    (tmp / f"features_{i}" / "llm_ready_summary.json").read_text())
                summaries[which].pop("analysis_date")  # the clock, not a feature
            del os.environ["BRAINTPU_DEVICE_FEATURES"]
            same = summaries["native"] == summaries["scipy"]
            print(json.dumps({"features": {
                "case": "BraTS-SYN-00200-000 240x240x155", "native_available":
                native.native_available(), "native_s": secs["native"], "scipy_s": secs["scipy"],
                "native_s_min": min(secs["native"]), "scipy_s_min": min(secs["scipy"]),
                "summaries_equal": same}}), flush=True)
            if not same:
                raise AssertionError("the feature summary differs between the native EDT and scipy")

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
            if int8_matmul.launches:
                raise AssertionError("the segmentation path launched int8_matmul")
            if tuple(info2["bucket_shape"]) != tuple(main_bucket):
                raise AssertionError(f"bucket {info2['bucket_shape']} != {main_bucket}")
            expect_counts(main_launches, two_model_launches(main_bucket),
                          f"two models at bucket {info2['bucket_shape']}")
            want_route = "native" if native.native_available() else "python"
            if info2["decode_route"] != want_route:
                raise AssertionError(f"decode route {info2['decode_route']} != {want_route}")
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
                "dice": dice2, "decode_route": info2["decode_route"],
                "note": "Dice is information only: model 2's weights are random",
            }), flush=True)

        # the ET rule, watched: the softmax ensemble runs it once per case,
        # the label ensemble never
        et_calls = []
        real_et_rule = engine_mod.et_min_size_postprocess

        def counting_et_rule(*a, **kw):
            et_calls.append(1)
            return real_et_rule(*a, **kw)

        with phase("8b two-model engine, sliding mode (seed 50, 240x240x155)"):
            engine2s = load_engine(build_parser().parse_args(
                ["segment", "--input", str(brats_size), "--output", str(tmp / "out2s"),
                 "--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
                 "--random-weights", "--mode", "sliding"]))
            engine_mod.et_min_size_postprocess = counting_et_rule
            try:
                reset_counts()
                _, info2s, dice2s = segment(engine2s, brats_size)
            finally:
                engine_mod.et_min_size_postprocess = real_et_rule
            sliding_counts = counts()
            sb = tuple(info2s["bucket_shape"])
            n_patches = len(patch_grid(sb, patch))
            want = sliding_launches(MODEL1_BN, sb)
            for k, v in sliding_launches(MODEL2_GN_LARGE, sb).items():
                want[k] = want.get(k, 0) + v
            expect_counts(sliding_counts, want, f"sliding, two models, {n_patches} patches of {sb}")
            if int8_matmul.launches or len(et_calls) != 1:
                raise AssertionError(f"int8_matmul launched or ET rule calls {len(et_calls)} != 1")
            times2s, _, peak2s = timed(engine2s, brats_size)
            profile_case(torch, lambda: segment(engine2s, brats_size), None, what="sliding")
            print(json.dumps({"sliding_two_models": {
                "case": "BraTS-SYN-00050-000 240x240x155",
                "models": "model1 (2 trained folds) + model2 (init_params seeds 1000, 1001)",
                "padded_shape": sb, "patches": n_patches,
                "mirror_chunk": {"model1": chunk[MODEL1_BN], "model2": chunk[MODEL2_GN_LARGE]},
                "s_per_case_min": min(times2s), "s_per_case_median": statistics.median(times2s),
                "s_per_case": times2s, "kernel_launches_per_case": sliding_counts,
                "max_memory_allocated_bytes": peak2s,
                "analytic_tflop_per_case": (forward_flops(MODEL1_BN, patch)
                                            + forward_flops(MODEL2_GN_LARGE, patch))
                                           * n_patches * 8 * 2 / 1e12,
                "fullconv_same_run": {"s_per_case_min": min(times2),
                                      "s_per_case_median": statistics.median(times2),
                                      "s_per_case": times2, "bucket": info2["bucket_shape"],
                                      "max_memory_allocated_bytes": peak2},
                "dice": dice2s, "note": "Dice is information only: model 2's weights are random",
            }}), flush=True)

        with phase("8c two-model label ensemble (sliding, seed 50)"):
            # the label run: round(mean of the models' label maps), checked
            # against that recipe on the engine's own probabilities, and no
            # ET rule
            seen = {}
            ensemble_labels = type(engine2s)._ensemble_labels

            def watching(per_model_probs, pre):
                out = ensemble_labels(engine2s, per_model_probs, pre)
                segs = [region_probs_to_labels(p)[pre.undo_slices].cpu().numpy()
                        for p in per_model_probs]
                seen["manual"] = np.round(sum(s.astype(np.float32) for s in segs)
                                          / len(segs)).astype(np.uint8)
                seen["ties"] = int(((segs[0].astype(np.int32) + segs[1]) % 2).sum())
                seen["out"] = out
                return out

            engine2s.ensemble, engine2s._ensemble_labels = "label", watching
            et_calls.clear()
            engine_mod.et_min_size_postprocess = counting_et_rule
            try:
                reset_counts()
                segl, infol, dicel = segment(engine2s, brats_size)
            finally:
                engine_mod.et_min_size_postprocess = real_et_rule
                engine2s.ensemble = "softmax"
                del engine2s._ensemble_labels
            label_counts = counts()
            labels = sorted(int(v) for v in np.unique(segl))
            print(json.dumps({"label_ensemble": {
                "case": "BraTS-SYN-00050-000 240x240x155", "ensemble": infol["ensemble"],
                "labels": labels, "ties_rounded_half_to_even": seen["ties"],
                "et_rule_calls": len(et_calls), "launches": label_counts, "dice": dicel,
                "equals_round_of_mean_labels": bool(np.array_equal(seen["out"], seen["manual"])),
                "note": "Dice is information only: model 2's weights are random"}}), flush=True)
            if infol["ensemble"] != "label" or et_calls or not set(labels) <= {0, 1, 2, 3}:
                raise AssertionError(f"label ensemble: {infol['ensemble']}, ET rule calls "
                                     f"{len(et_calls)}, labels {labels}")
            if not np.array_equal(seen["out"], seen["manual"]) or label_counts != sliding_counts:
                raise AssertionError("label ensemble differs from round(mean of label maps) "
                                     f"or launched {label_counts} != {sliding_counts}")
            del engine2s
            torch.cuda.empty_cache()

        with phase("8d cli segment's loop over three cases: serial vs prefetched"):
            # cmd_segment's loop with the two-model fullconv engine over three
            # 240x240x155 cases, each saved: decode inside predict_case
            # (serial) or on CasePrefetcher's thread; in turns
            cases3 = [find_cases(d)[0] for d in (brats_size, flagship, third)]
            out3 = tmp / "out3"

            def serial():
                for case in cases3:
                    engine2.predict_case(case, out3 / f"{case.case_id}.nii.gz")

            def prefetched():
                for case, loaded in CasePrefetcher(cases3):
                    engine2.predict_case(case, out3 / f"{case.case_id}.nii.gz", loaded=loaded)

            walls = {"serial": [], "prefetched": []}
            print("# cut: one serial and one prefetched loop (two of each in turns before), "
                  "for the smoke's time")
            for which in ("serial", "prefetched"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (serial if which == "serial" else prefetched)()
                torch.cuda.synchronize()
                walls[which].append(time.perf_counter() - t0)
            print(json.dumps({"prefetch": {
                "cases": [c.case_id for c in cases3], "engine": "two models, fullconv",
                "serial_s": walls["serial"], "prefetched_s": walls["prefetched"],
                "serial_s_min": min(walls["serial"]),
                "prefetched_s_min": min(walls["prefetched"])}}), flush=True)

        with phase("9 profile of one two-model case"):
            profile_case(torch, lambda: segment(engine2, brats_size),
                         Path(args.trace) if args.trace else None, what="fullconv")
        del engine2
        torch.cuda.empty_cache()

        # cli serve's engine flags: phase 8's weights, fullconv (the default), TTA
        serve_flags = ["--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
                       "--random-weights"]
        with phase("10 serve (in process)"):
            serve_args = build_parser().parse_args(
                ["serve", "--host", "127.0.0.1", "--port", "0", "--root", str(tmp / "serve")]
                + serve_flags)
            engine_sv = load_engine(serve_args)
            t0 = time.perf_counter()
            server = make_server(engine_sv, Path(serve_args.root), host=serve_args.host,
                                 port=serve_args.port)
            bind_s = time.perf_counter() - t0
            threading.Thread(target=server.serve_forever, daemon=True, name="smoke-serve").start()
            url = f"http://127.0.0.1:{server.server_address[1]}"
            jobs, t_submit, ended = {}, {}, {}
            try:
                warmup_s = engine_sv.warmup()
                torch.cuda.synchronize()
                reset_counts()
                status_lat = []
                # one job alone: seed 200 at 240x240x155 as multipart, with its _seg
                t0 = time.perf_counter()
                jobs["alone"] = submit(url, flagship)
                t_submit[jobs["alone"]] = t0
                ended.update(wait_jobs(url, [jobs["alone"]], t_submit, latencies=status_lat))
                # two jobs in flight at once: seeds 50 and 51 as JSON, wrapped base64
                torch.cuda.reset_peak_memory_stats()
                t_pair = time.perf_counter()
                for name, case_dir in (("seed50", brats_size), ("seed51", third)):
                    t0 = time.perf_counter()
                    jobs[name] = submit(url, case_dir, as_json=True)
                    t_submit[jobs[name]] = t0
                ended.update(wait_jobs(url, [jobs["seed50"], jobs["seed51"]], t_submit,
                                       latencies=status_lat))
                pair_wall = time.perf_counter() - t_pair
                pair_peak = torch.cuda.max_memory_allocated()
                torch.cuda.synchronize()
                served_launches = counts()
                int8_served = int8_matmul.launches
                # the pair once more on the other side of the feature-routing
                # decision (phase 13a): the host route when 'auto' takes device
                # groups, else every group on the card
                alt_route = "0" if MEASURED_WIN_GROUPS else "all"
                os.environ["BRAINTPU_DEVICE_FEATURES"] = alt_route
                try:
                    t_alt = time.perf_counter()
                    for name, case_dir in (("seed50_alt", brats_size), ("seed51_alt", third)):
                        t0 = time.perf_counter()
                        jobs[name] = submit(url, case_dir, as_json=True)
                        t_submit[jobs[name]] = t0
                    ended.update(wait_jobs(url, [jobs["seed50_alt"], jobs["seed51_alt"]],
                                           t_submit, latencies=status_lat))
                    alt_pair_wall = time.perf_counter() - t_alt
                finally:
                    del os.environ["BRAINTPU_DEVICE_FEATURES"]
                j200 = jobs["alone"]
                lat = {"status": status_lat, "report": [], "pdf": [], "metrics": [], "chat": []}
                bodies = {}
                for _ in range(5):
                    for what, path in (("report", f"/api/report/{j200}"),
                                       ("pdf", f"/api/report/{j200}/pdf"),
                                       ("metrics", f"/api/metrics/{j200}")):
                        code, bodies[what], _, s = http(url + path)
                        lat[what].append(s)
                        if code != 200:
                            raise AssertionError(f"GET {path}: HTTP {code}")
                chats = {}
                for label, question in (("clinical", "What treatment should the patient get?"),
                                        ("educational", "What is peritumoral edema?")):
                    for _ in range(3):
                        code, body, _, s = http(url + f"/api/chat/{j200}", json.dumps(
                            {"question": question}).encode(), {"Content-Type": "application/json"},
                            "POST")
                        lat["chat"].append(s)
                    chats[label] = (code, json.loads(body))
            finally:
                # every submitted job reaches done or error before the shutdown
                running = [j for j in jobs.values() if j not in ended]
                if running:
                    wait_jobs(url, running, {j: time.perf_counter() for j in running})
                server.shutdown()
                server.server_close()
            from braintpu_torch.rag import REFUSAL_DATA
            from braintpu_torch.serve import CLINICAL_REFUSAL

            bad = {n: ended[j][0] for n, j in jobs.items() if ended[j][0]["status"] != "done"}
            if bad:
                raise AssertionError(f"served jobs not done: {bad}")
            metrics = json.loads(bodies["metrics"])
            if b"MRI BRAIN WITH CONTRAST" not in bodies["report"] or bodies["pdf"][:4] != b"%PDF" \
                    or not np.isfinite(metrics["mean_dice"]):
                raise AssertionError("served report, PDF or metrics malformed")
            if chats["clinical"] != (400, {"detail": CLINICAL_REFUSAL}) or \
                    chats["educational"] != (200, {"answer": REFUSAL_DATA}):
                raise AssertionError(f"chat answers: {chats}")
            _, bucket51 = bucket_of(third)
            want = {}
            for b in (buckets["flagship_geometry"], main_bucket, bucket51):
                for k, v in two_model_launches(b).items():
                    want[k] = want.get(k, 0) + v
            expect_counts(served_launches, want, "three served jobs (after warm-up)")
            if int8_served:
                raise AssertionError("the serving path launched int8_matmul")
            journals = {n: [json.loads(ln) for ln in server.app.jobs.artifact(
                j, "events.jsonl").read_text().splitlines()] for n, j in jobs.items()}
            seg_span = {n: (next(e["t"] for e in ev if e["stage"] == "segmenting"),
                            next(e["t"] for e in ev if e["stage"] == "segmenting"
                                 and e["status"] == "ok")) for n, ev in journals.items()}
            overlap = min(seg_span["seed50"][1], seg_span["seed51"][1]) - \
                max(seg_span["seed50"][0], seg_span["seed51"][0])
            # the same case through Pipeline.run_case on the same engine
            direct = Pipeline(engine_sv, PipelineConfig(output_root=tmp / "serve_direct")).run_case(
                flagship)
            torch.cuda.synchronize()
            cid = find_cases(flagship)[0].case_id
            served = nifti.load(server.app.jobs.artifact(j200, f"{cid}_brats.nii.gz")).get_fdata(
                dtype="float32")
            direct_labels = nifti.load(direct.output_folder / f"{cid}_brats.nii.gz").get_fdata(
                dtype="float32")
            agreement = float((served == direct_labels).mean())
            med = lambda xs: statistics.median(xs) * 1e3
            print(json.dumps({"serve": {
                "engine": "model1 (2 trained folds) + model2 (init_params seeds 1000, 1001), "
                          "fullconv, 8-flip TTA", "bind_s": bind_s, "warmup_s": warmup_s,
                "jobs": {n: {"job": j, "submit_to_done_s": ended[j][1],
                             "stage_seconds": stage_spans(journals[n])}
                         for n, j in jobs.items()},
                "feature_route": {"auto": sorted(MEASURED_WIN_GROUPS),
                                  "alt_pair": alt_route},
                "alone_s": ended[j200][1], "pair_wall_s": pair_wall,
                "alt_route_pair_wall_s": alt_pair_wall,
                "pair_segment_overlap_s": overlap,
                "pair_max_memory_allocated_bytes": pair_peak,
                "request_ms_median": {k: med(v) for k, v in lat.items()},
                "requests": {k: len(v) for k, v in lat.items()},
                "launches": served_launches, "launches_want": want,
                "served_vs_direct_label_agreement": agreement,
                "mean_dice_seed200": metrics["mean_dice"],
                "note": "Dice is information only: model 2's weights are random"}}), flush=True)
            if not direct.succeeded or agreement < 0.9999:
                raise AssertionError(f"served labels agree with a direct run on {agreement} < 0.9999")
            del engine_sv, direct
            torch.cuda.empty_cache()

        with phase("10b cli serve as a process"):
            cmd = [sys.executable, "-u", "-m", "braintpu_torch.cli", "serve", "--host", "127.0.0.1",
                   "--port", "0", "--root", str(tmp / "serve_proc")] + serve_flags
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env={**os.environ, "GEMINI_API_KEY": ""})
            lines, log = queue.Queue(), []
            threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout] + [lines.put(None)],
                             daemon=True).start()

            def expect_line(prefix, timeout_s):
                deadline = time.perf_counter() + timeout_s
                while time.perf_counter() < deadline:
                    try:
                        ln = lines.get(timeout=1.0)
                    except queue.Empty:
                        continue
                    if ln is None:
                        raise AssertionError(f"cli serve exited before {prefix!r}: {log[-20:]}")
                    log.append(ln.rstrip())
                    if ln.startswith(prefix):
                        return ln, time.perf_counter() - t0
                raise AssertionError(f"no {prefix!r} from cli serve in {timeout_s} s: {log[-20:]}")

            try:
                ln, bound_s = expect_line("serving on ", 300)
                purl = f"http://127.0.0.1:{int(ln.split()[2].rsplit(':', 1)[1])}"
                warm_line, warm_s = expect_line("engine warmup done", 600)
                t_sub = {}
                t1 = time.perf_counter()
                job = submit(purl, flagship)
                t_sub[job] = t1
                (status, done_s), = wait_jobs(purl, [job], t_sub).values()
                if status["status"] != "done":
                    raise AssertionError(f"cli serve job: {status}")
                proc.send_signal(signal.SIGINT)
                rc = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            while not lines.empty():
                ln = lines.get()
                if ln is not None:
                    log.append(ln.rstrip())
            print(json.dumps({"cli_serve": {"bind_s_from_start": bound_s,
                                            "warmup_done_s_from_start": warm_s,
                                            "warmup_line": warm_line.strip(),
                                            "job_submit_to_done_s": done_s, "exit_code": rc,
                                            "output": log[-8:]}}), flush=True)
            if rc != 0:
                raise AssertionError(f"cli serve exited with {rc} on SIGINT")

        with phase("10c check-env"):
            out = subprocess.run([sys.executable, "-m", "braintpu_torch.cli", "check-env",
                                  "--checkpoints", str(CKPTS)], cwd=ROOT, capture_output=True,
                                 text=True, timeout=300)
            print(out.stdout + out.stderr, flush=True)
            if out.returncode != 0:
                raise AssertionError(f"check-env exited with {out.returncode} on the card")

        with phase("11 train (both models, full width, 128^3, batch 2, bf16)"):
            # the recipe's synthetic dataset: train seeds 0-11, held-out seed 100
            train_dir, val_dir = tmp / "train", tmp / "val"
            write_synth_dataset(train_dir, 12, seed0=0)
            write_synth_dataset(val_dir, 1, seed0=100)
            train_cases = find_cases(train_dir)

            it = iter(PatchSampler(train_cases, patch_size=patch, batch_size=2, seed=0))
            batches = [next(it) for _ in range(4)]
            train_results = {}
            for name, cfg, n_timed in (("model1", MODEL1_BN, 20), ("model2", MODEL2_GN_LARGE, 10)):
                train_results[name] = train_run(torch, cfg, batches, 3, n_timed, kernels)
                print(json.dumps({"train": {name: train_results[name]}}), flush=True)

        recipe_steps = 100
        print(f"# cut: the recipe runs {recipe_steps} steps (300, then 150 before), for the "
              "smoke's time")
        with phase(f"11b recipe: model 1, 64^3, batch 2, LR 0.01, mirror, {recipe_steps} steps"):
            # tools/train_synthetic.py's recipe (init seed 0, sampler seed 0,
            # its 2500-step schedule), stopped early; then export, segment
            rcfg = dataclasses.replace(MODEL1_BN, patch_size=(64,) * 3)
            tc = TrainConfig(base_lr=0.01, max_steps=2500)
            state = create_train_state(init_params(rcfg, 0), tc, device="cuda")
            sampler = PatchSampler(train_cases, patch_size=(64,) * 3, batch_size=2, seed=0,
                                   mirror=True)
            losses = {}
            reset_counts()
            t0 = time.perf_counter()
            state = fit(state, iter(sampler), rcfg, tc, num_steps=recipe_steps,
                        generator=torch.Generator(device="cuda").manual_seed(1000),
                        on_metrics=lambda m: losses.__setitem__(int(m["step"]), m["loss"]))
            torch.cuda.synchronize()
            recipe_s = time.perf_counter() - t0
            recipe_launches = counts()
            ref_losses = {r["step"]: r["loss"] for r in
                          map(json.loads, REF_TRAIN_LOG.read_text().splitlines())}
            fold = tmp / "recipe" / "model1" / "fold_0.npz"
            save_pytree_npz(params_to_jax(state.params, rcfg), fold)
            del state
            torch.cuda.empty_cache()
            engine_r = load_engine(build_parser().parse_args(
                ["segment", "--input", str(val_dir), "--output", str(tmp / "out_recipe"),
                 "--checkpoints", str(tmp / "recipe"), "--models", "model1", "--folds", "1"]))
            _, info_r, dice_r = segment(engine_r, val_dir)
            del engine_r
            torch.cuda.empty_cache()
            shown = sorted({1, 50, recipe_steps} | {k for k in ref_losses if k <= recipe_steps})
            print(json.dumps({"recipe": {
                "model": "MODEL1_BN", "patch": [64, 64, 64], "batch": 2, "base_lr": 0.01,
                "schedule_max_steps": 2500, "steps": recipe_steps, "wall_s": recipe_s,
                "s_per_step_mean": recipe_s / recipe_steps, "launches": recipe_launches,
                "loss": {k: losses[k] for k in shown if k in losses},
                "reference_loss": {k: ref_losses[k] for k in shown if k in ref_losses},
                "heldout": "BraTS-SYN-00100-000", "heldout_dice": dice_r,
                "note": "the reference's losses are its TPU run's, information only; the "
                        "wall time includes the host's patch sampling"}}), flush=True)
            if not all(np.isfinite(v) for v in losses.values()) or len(losses) != recipe_steps:
                raise AssertionError(f"recipe: {len(losses)} steps, non-finite loss")

        with phase("11c cli train as a process, then resumed"):
            ck = tmp / "train_ck"
            cmd = [sys.executable, "-u", "-m", "braintpu_torch.cli", "train", "--model", "model1",
                   "--data", str(train_dir), "--checkpoint-dir", str(ck), "--log-every", "1"]
            runs = []
            for steps in (2, 4):
                t0 = time.perf_counter()
                out = subprocess.run(cmd + ["--steps", str(steps)], cwd=ROOT, capture_output=True,
                                     text=True, timeout=600)
                runs.append({"steps": steps, "exit_code": out.returncode,
                             "s": time.perf_counter() - t0,
                             "output": out.stdout.strip().splitlines()[-6:]})
                if out.returncode != 0:
                    raise AssertionError(f"cli train --steps {steps} exited {out.returncode}: "
                                         f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            second = "\n".join(runs[1]["output"])
            saved = sorted(int(p_.name) for p_ in ck.iterdir() if p_.name.isdigit())
            resumed = ("step       3" in second and "step       1" not in second
                       and "done at step 4" in second)
            print(json.dumps({"cli_train": {"runs": runs, "checkpoints": saved,
                                            "resumed_at_step_3": resumed}}), flush=True)
            if not resumed or saved != [2, 4]:
                raise AssertionError(f"cli train did not resume: checkpoints {saved}")

        with phase("11d convert-checkpoint: a full-width .model and a raw nnU-Net tree"):
            tree = load_pytree_npz(CKPTS / "model1" / "fold_0.npz")
            model_root = tmp / "ck_model"
            mfile = model_root / "model1" / "fold_0" / "model_final_checkpoint.model"
            mfile.parent.mkdir(parents=True)
            torch.save({"state_dict": nnunet_state_dict(torch, tree, MODEL1_BN), "epoch": 1000},
                       mfile)
            raw = (tmp / "ck_tree" / "3d_fullres" / "Task500_BraTS2021"
                   / "nnUNetTrainerV2BraTSRegions_DA4_BN_BD__nnUNetPlansv2.1" / "fold_0")
            raw.mkdir(parents=True)
            shutil.copy(mfile, raw / mfile.name)
            npz_root = tmp / "ck_npz"
            if cli_main(["convert-checkpoint", "--input", str(mfile), "--output",
                         str(npz_root / "model1" / "fold_0.npz"), "--config", "model1"]) != 0:
                raise AssertionError("convert-checkpoint failed")
            conv = load_pytree_npz(npz_root / "model1" / "fold_0.npz")
            flat_a = {k: v for k, v in _flat(tree)}
            exact = all(np.array_equal(flat_a[k].astype(np.float32), v) for k, v in _flat(conv))
            labels = {}
            for src, root_ in (("npz", npz_root), ("model", model_root),
                               ("tree", tmp / "ck_tree")):
                out_dir = tmp / f"seg_{src}"
                if cli_main(["segment", "--input", str(anchor), "--output", str(out_dir),
                             "--checkpoints", str(root_), "--models", "model1", "--folds",
                             "1"]) != 0:
                    raise AssertionError(f"segment from the {src} checkpoint failed")
                labels[src] = nifti.load(out_dir / "BraTS-SYN-00200-000.nii.gz").get_fdata(
                    dtype="float32")
            same = {k: bool(np.array_equal(labels["npz"], labels[k])) for k in ("model", "tree")}
            print(json.dumps({"convert": {"source": "results/trained_synth/checkpoints/model1/"
                                          "fold_0.npz as an nnU-Net state dict",
                                          "converted_equals_source_f32": exact,
                                          "labels_equal_to_npz": same}}), flush=True)
            if not exact or not all(same.values()):
                raise AssertionError(f"conversion: exact {exact}, same labels {same}")

        from braintpu_torch.infer.sliding_window import MIRROR_COMBOS
        from braintpu_torch.models import axial
        from braintpu_torch.models.unet3d import AXIAL_UNET, AXIAL_UNET_FULL, attention_plan
        from braintpu_torch.ops.conv3d import conv3d_tap_merged_ref
        from braintpu_torch.ops.upconv import upconv2x_ref

        def cfg_tap_layers(cfg, bucket, batch):
            return [(s_, co) for s_, st, co in conv_layers(cfg, bucket, batch)
                    if choose_impl(s_, (3, 3, 3), st, co, cfg.compute_dtype) == "kernel"]

        def axial_launches(cfg, bucket, folds):
            """One sliding case: patches x 8/N x folds forwards, each through
            the dispatch's tap and up-conv layers at (N, 128^3)."""
            n = default_mirror_chunk(cfg)
            forwards = len(patch_grid(bucket, patch)) * (8 // n) * folds
            return {"conv3d_tap_merged": forwards * len(cfg_tap_layers(cfg, patch, n)),
                    "upconv2x": forwards * len(up_layers(cfg, patch, n))}

        def times_of(eng, case_dir, runs=2):
            """predict_case seconds of ``runs`` runs (the caller has warmed
            the engine up) and the peak device memory over them."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = []
            for _ in range(runs):
                t0 = time.perf_counter()
                eng.predict_case(find_cases(case_dir)[0])
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            return out, torch.cuda.max_memory_allocated()

        def axial_checks(cfg, case_dir):
            """On one 128^3 patch of the case x 8 mirrors: the forward through
            the kernels, each launch held against its plain version on the
            same inputs (within TOL of max|plain|), against the same forward
            with every kernel replaced by its plain version (label agreement,
            finite logits, launches), beside the plain forward of an input
            perturbed by 1e-3 (relative; information: how sensitive the
            weights are); and one attention stage chunked against unchunked
            (bit equality).  The weights: model 1's trained fold 0 for the
            convs (the axial families have model 1's conv plan) and the
            config's attention from ``init_params(cfg, 0)``.  All-random
            weights are chaotic at 128^3: a 1e-3 input perturbation flips
            40 % (AXIAL_UNET) and 22 % (AXIAL_UNET_FULL) of their labels in
            an f32 CPU forward, so labels cannot hold kernels to their
            plain versions there."""
            tree = load_pytree_npz(CKPTS / "model1" / "fold_0.npz")
            trained = ModelBundle.from_folds(MODEL1_BN, [params_from_jax(tree, MODEL1_BN)])
            attn = ModelBundle.from_folds(cfg, [init_params(cfg, 0)]).fold_params[0]
            tp = trained.fold_params[0]
            params = {**attn, "encoder": tp["encoder"], "bottleneck": tp["bottleneck"],
                      "decoder": [{**a_st, **t_st} for a_st, t_st in
                                  zip(attn["decoder"], tp["decoder"])]}
            params = ModelBundle(cfg, [params], True, "mixed").to(torch.device("cuda")) \
                .fold_params[0]
            data, _, _ = load_case_volumes(find_cases(case_dir)[0])
            pre = preprocess_case(data, patch_size=patch, device=torch.device("cuda"))
            x0 = pre.data.movedim(0, -1)[:patch[0], :patch[1], :patch[2]]
            x = torch.stack([torch.flip(x0, [a for a in axes]) for axes in MIRROR_COMBOS])
            g = torch.Generator(device="cuda").manual_seed(13)
            xp = x * (1 + 1e-3 * torch.randn(x.shape, device="cuda", generator=g))
            errs = []

            def held(kernel, plain):
                def run(*a):
                    out = kernel(*a)
                    ref = plain(*a)
                    err = float((out.float() - ref.float()).abs().max())
                    tol = TOL * float(ref.float().abs().max())
                    errs.append((kernel.__name__, tuple(a[0].shape), err, tol))
                    return out
                return run

            reset_counts()
            unet3d.conv3d_tap_merged = held(conv3d_tap_merged, conv3d_tap_merged_ref)
            unet3d.upconv2x = held(upconv2x, lambda a_, w_: upconv2x_ref(a_, w_, torch.bfloat16))
            try:
                with torch.inference_mode():
                    kern = unet3d.apply_unet(params, x, cfg, folded=True)
                torch.cuda.synchronize()
                launched = counts()
                unet3d.conv3d_tap_merged = conv3d_tap_merged_ref
                unet3d.upconv2x = lambda a_, w_: upconv2x_ref(a_, w_, torch.bfloat16)
                with torch.inference_mode():
                    plain = unet3d.apply_unet(params, x, cfg, folded=True)
                    perturbed = unet3d.apply_unet(params, xp, cfg, folded=True)
                torch.cuda.synchronize()
            finally:
                unet3d.conv3d_tap_merged, unet3d.upconv2x = conv3d_tap_merged, upconv2x
            agree = float(((kern > 0) == (plain > 0)).float().mean())
            finite = bool(torch.isfinite(kern).all() and torch.isfinite(plain).all())
            want = {"conv3d_tap_merged": len(cfg_tap_layers(cfg, patch, 8)), "conv_stage": 0,
                    "upconv2x": len(up_layers(cfg, patch, 8))}
            bad = [e for e in errs if not e[2] <= e[3]]
            # the attention of the finest attending decoder stage, on a
            # random bf16 input of its shape at N = 8
            plan = attention_plan(cfg)["decoder"]
            u = max(plan)
            spec = plan[u]
            a_params = params["decoder"][u][spec["kind"]]
            a_params = a_params["attn"] if spec["kind"] == "attn_block" else a_params
            xa = torch.randn((8, *spec["shape"], spec["channels"]), device="cuda",
                             generator=g).bfloat16()
            outs = {}
            saved = axial._MAX_LOGIT_BYTES
            try:
                for mib in (64, 8192):
                    axial._MAX_LOGIT_BYTES = mib << 20
                    with torch.inference_mode():
                        outs[mib] = axial.apply_axial_attention(
                            a_params, xa, spec["dim_head"], spec["kind"] == "attn_block")
            finally:
                axial._MAX_LOGIT_BYTES = saved
            chunk_equal = bool(torch.equal(outs[64], outs[8192]))
            r = {"patch_forward": {
                    "weights": "model 1 trained fold 0 convs + init_params(cfg, 0) attention",
                    "launches": launched, "launches_formula": want,
                    "launches_held_to_plain": len(errs), "launches_off_tolerance": bad,
                    "max_abs_err_per_launch": max(e[2] for e in errs),
                    "label_agreement_kernels_vs_plain": agree,
                    "label_agreement_plain_vs_perturbed_input": float(
                        ((perturbed > 0) == (plain > 0)).float().mean()),
                    "foreground_share": float((plain > 0).float().mean()),
                    "max_abs_logit_diff": float((kern - plain).abs().max()),
                    "max_abs_logit": float(plain.abs().max()), "finite": finite},
                 "chunked_vs_unchunked": {"decoder_stage": u, "shape": [8, *spec["shape"],
                                                                        spec["channels"]],
                                          "budgets_mib": [64, 8192], "equal": chunk_equal}}
            if (launched != want or bad or len(errs) != sum(want.values()) or agree < 0.999
                    or not finite or not chunk_equal):
                raise AssertionError(f"axial checks failed: {r}")
            return r

        axial_counts = {}
        for name, cfg, folds, ph in (("axial", AXIAL_UNET, 2, "12"),
                                     ("axial-full", AXIAL_UNET_FULL, 1, "12b")):
            with phase(f"{ph} {name}: sliding, full width, seed 50, "
                       f"{folds} fold(s), 8-flip TTA"):
                eng_a = load_engine(build_parser().parse_args(
                    ["segment", "--input", str(brats_size), "--output", str(tmp / f"out_{name}"),
                     "--models", name, "--folds", str(folds), "--random-weights"]))
                if eng_a.mode != "sliding":
                    raise AssertionError(f"{name}: load_engine chose {eng_a.mode}, not sliding")
                # the first case counts launches and checks the probabilities
                finite = []
                real_r2l = engine_mod.region_probs_to_labels

                def checking_r2l(p, *a, **kw):
                    finite.append(bool(torch.isfinite(p).all()))
                    return real_r2l(p, *a, **kw)

                engine_mod.region_probs_to_labels = checking_r2l
                try:
                    reset_counts()
                    _, info_a, dice_a = segment(eng_a, brats_size)
                finally:
                    engine_mod.region_probs_to_labels = real_r2l
                got = counts()
                sb = tuple(info_a["bucket_shape"])
                want = axial_launches(cfg, sb, folds)
                expect_counts({k: got[k] for k in want}, want,
                              f"{name}, sliding, {len(patch_grid(sb, patch))} patches")
                if not finite or not all(finite) or int8_matmul.launches or got["conv_stage"]:
                    raise AssertionError(f"{name}: probabilities finite {finite}, int8 "
                                         f"launches {int8_matmul.launches}, launches {got}")
                print("# cut: s/case over 2 runs after the counted one (3 before), "
                      "for the smoke's time")
                secs, peak_a = times_of(eng_a, brats_size)
                prof_a = attention_profile(torch, lambda: segment(eng_a, brats_size),
                                           f"{name} sliding")
                checks_a = axial_checks(cfg, brats_size)
                axial_counts[name] = got
                print(json.dumps({"axial_sliding": {
                    "model": name, "config": "AXIAL_UNET" if name == "axial" else
                    "AXIAL_UNET_FULL", "case": "BraTS-SYN-00050-000 240x240x155",
                    "folds": f"{folds} (init_params seeds {list(range(folds))})",
                    "mirror_chunk": default_mirror_chunk(cfg), "padded_shape": sb,
                    "patches": len(patch_grid(sb, patch)), "s_per_case": secs,
                    "s_per_case_min": min(secs), "s_per_case_median": statistics.median(secs),
                    "max_memory_allocated_bytes": peak_a, "launches": got,
                    "launches_formula": want, "probabilities_finite": all(finite),
                    "logit_budget_mib": axial._MAX_LOGIT_BYTES >> 20,
                    "attention": prof_a, **checks_a, "dice": dice_a,
                    "note": "Dice is information only: the weights are random"}}), flush=True)
                del eng_a
                torch.cuda.empty_cache()

        with phase("12c cli segment --models axial as a process (seed 200)"):
            torch.cuda.empty_cache()
            base = [sys.executable, "-u", "-m", "braintpu_torch.cli", "segment", "--input",
                    str(anchor), "--models", "axial", "--folds", "1", "--random-weights"]
            t0 = time.perf_counter()
            out = subprocess.run(base + ["--output", str(tmp / "cli_axial")], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t0
            written = (tmp / "cli_axial" / "BraTS-SYN-00200-000.nii.gz").is_file()
            refused = subprocess.run(base + ["--output", str(tmp / "cli_axial_fc"), "--mode",
                                             "fullconv"], cwd=ROOT, capture_output=True,
                                     text=True, timeout=600)
            print(json.dumps({"cli_axial": {
                "exit_code": out.returncode, "s": cli_s, "written": written,
                "output": out.stdout.strip().splitlines()[-3:],
                "fullconv_exit_code": refused.returncode,
                "fullconv_message": refused.stderr.strip().splitlines()[-1:]}}), flush=True)
            if (out.returncode != 0 or not written
                    or "# engine: mode sliding" not in out.stdout):
                raise AssertionError(f"cli segment --models axial: {out.returncode}\n"
                                     f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            if refused.returncode == 0 or AXIAL_FULLCONV_EXIT not in refused.stderr:
                raise AssertionError(f"--mode fullconv with axial: exit {refused.returncode}, "
                                     f"{refused.stderr[-1000:]}")

        with phase("12d train AXIAL_UNET (full width, 128^3, batch 2, bf16)"):
            train_results["axial"] = train_run(torch, AXIAL_UNET, batches, 3, 10, kernels)
            print(json.dumps({"train": {"axial": train_results["axial"]}}), flush=True)
            cmd = [sys.executable, "-u", "-m", "braintpu_torch.cli", "train", "--model", "axial",
                   "--data", str(train_dir), "--checkpoint-dir", str(tmp / "train_axial"),
                   "--log-every", "1", "--steps", "2"]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            print(json.dumps({"cli_train_axial": {
                "exit_code": out.returncode, "s": time.perf_counter() - t0,
                "output": out.stdout.strip().splitlines()[-4:]}}), flush=True)
            if out.returncode != 0 or "done at step 2" not in out.stdout:
                raise AssertionError(f"cli train --model axial: {out.returncode}\n"
                                     f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")

        with phase("12e batched two-model fullconv engine (seeds 50, 55, 200; batch 2)"):
            engine_b = load_engine(build_parser().parse_args(
                ["segment", "--input", str(brats_size), "--output", str(tmp / "outb"),
                 "--checkpoints", str(root), "--models", "model1,model2", "--folds", "2",
                 "--random-weights"]))
            cases_b = [find_cases(d)[0] for d in (brats_size, pair, flagship)]
            buckets_b = {}
            for c in cases_b:
                buckets_b.setdefault(tuple(bucket_of(c.folder)[1]), []).append(c.case_id)
            # warm-up: each bucket once per case and once at the batch shape
            for c in cases_b:
                engine_b.predict_case(c)
            engine_b.predict_cases_batched(cases_b, batch_size=2)
            torch.cuda.synchronize()
            per_case = {c.case_id: engine_b.predict_case(c)[0] for c in cases_b}
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            batched = engine_b.predict_cases_batched(cases_b, batch_size=2)
            torch.cuda.synchronize()
            peak_b = torch.cuda.max_memory_allocated()
            got_b = counts()
            want_b = {"conv3d_tap_merged": 0, "conv_stage": 0, "upconv2x": 0}
            for bucket in buckets_b:  # one batch of 2 per bucket (the lone case padded)
                want_b["conv3d_tap_merged"] += 16 * len(tap_layers(bucket, 2))
                want_b["conv_stage"] += 16 * len(stage_layers(bucket, 2))
                want_b["upconv2x"] += 16 * (len(up_layers(MODEL1_BN, bucket, 2))
                                            + len(up_layers(MODEL2_GN_LARGE, bucket, 2)))
            expect_counts(got_b, want_b, f"batched, buckets {sorted(buckets_b)}")
            agree_b = {i["case_id"]: float((seg == per_case[i["case_id"]]).mean())
                       for seg, i in batched}
            # serial against batched, in turns
            walls = {"serial": [], "batched": []}
            print("# cut: one serial and one batched run (two of each in turns before), "
                  "for the smoke's time")
            for which in ("serial", "batched"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if which == "serial":
                    for c in cases_b:
                        engine_b.predict_case(c)
                else:
                    engine_b.predict_cases_batched(cases_b, batch_size=2)
                torch.cuda.synchronize()
                walls[which].append(time.perf_counter() - t0)
            batched_launches = got_b
            batch_sizes = [i["batch_size"] for _, i in batched]
            # the process below needs the card's memory: free this one's
            del engine_b, batched
            torch.cuda.empty_cache()
            # cli segment --batch-cases 2 as a process over the same three cases
            root_b = tmp / "batch_in"
            root_b.mkdir()
            for c in cases_b:
                (root_b / c.case_id).symlink_to(c.folder, target_is_directory=True)
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-u", "-m", "braintpu_torch.cli", "segment", "--input",
                 str(root_b), "--output", str(tmp / "cli_batched"), "--checkpoints", str(root),
                 "--models", "model1,model2", "--folds", "2", "--random-weights",
                 "--batch-cases", "2", "--convention", "brats2025"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            cli_b_s = time.perf_counter() - t0
            cli_agree = {}
            if out.returncode == 0:
                for c in cases_b:
                    f = tmp / "cli_batched" / f"{c.case_id}.nii.gz"
                    cli_agree[c.case_id] = float((np.asarray(nifti.load(f).dataobj)
                                                  == per_case[c.case_id]).mean())
            serial_case = min(walls["serial"]) / len(cases_b)
            batched_case = min(walls["batched"]) / len(cases_b)
            print(json.dumps({"batched": {
                "cases": [c.case_id for c in cases_b], "buckets": {
                    "x".join(map(str, b)): ids for b, ids in buckets_b.items()},
                "engine": "two models, fullconv (phase 8's weights), 8-flip TTA",
                "batch_size": 2, "batch_sizes": batch_sizes,
                "serial_s": walls["serial"], "batched_s": walls["batched"],
                "serial_s_per_case_min": serial_case, "batched_s_per_case_min": batched_case,
                "batched_over_serial": batched_case / serial_case,
                "phase8_serial_s_per_case_min_seed50": min(times2),
                "max_memory_allocated_bytes": peak_b, "launches": got_b,
                "launches_formula": want_b, "label_agreement_with_per_case": agree_b,
                "cli": {"exit_code": out.returncode, "s": cli_b_s,
                        "output": out.stdout.strip().splitlines()[-3:],
                        "label_agreement_with_per_case": cli_agree}}}), flush=True)
            if min(agree_b.values()) < 0.9999 or list(agree_b) != [c.case_id for c in cases_b]:
                raise AssertionError(f"batched labels: {agree_b}")
            if out.returncode != 0 or len(cli_agree) != 3 or min(cli_agree.values()) < 0.9999:
                raise AssertionError(f"cli segment --batch-cases 2: {out.returncode} {cli_agree}"
                                     f"\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")

        case200 = find_cases(flagship)[0]
        seg200 = result.output_folder / f"{case200.case_id}_brats.nii.gz"  # phase 6b's labels
        with phase("13a feature steps by device route (seed 200, 240x240x155, min of 2)"):
            torch.cuda.empty_cache()
            fr = feature_routes(flagship, seg200, "cuda", tmp / "routes")
            host = fr["routes"]["0"]
            for route, r in fr["routes"].items():
                print(json.dumps({"feature_route": {
                    "route": route, "total_s_min": r["total_s_min"],
                    "host_total_s_min": host["total_s_min"], "total_s": r["total_s"],
                    "steps_s_min": r["steps_s_min"], "host_steps_s_min": host["steps_s_min"],
                    "summary_fields_off": r["summary_fields_off"]}}), flush=True)
            for g in GROUPS:
                d, h, o = fr["routes"][g]["total_s_min"], host["total_s_min"], fr["own_steps"][g]
                print(f"group {g}: its steps {'+'.join(o['steps'])} {o['card_s']:.3f} s on the "
                      f"card against {o['host_s']:.3f} s on the host; run_all_steps {d:.3f} s "
                      f"with it alone on the card against {h:.3f} s "
                      f"({'wins' if g in fr['winners'] else 'loses'})")
            print(f"all groups: run_all_steps {fr['routes']['all']['total_s_min']:.3f} s against "
                  f"{host['total_s_min']:.3f} s on the host; one upload per case serves the whole "
                  "set, so a group joins it when its own steps run faster on the card")
            print(f"MEASURED_WIN_GROUPS: committed {sorted(MEASURED_WIN_GROUPS)}; the groups that "
                  f"won in this run {fr['winners']} (agree: "
                  f"{sorted(MEASURED_WIN_GROUPS) == fr['winners']}); phase 10's served pair "
                  "reads the other side of the decision", flush=True)
            off = {r: v["summary_fields_off"] for r, v in fr["routes"].items()
                   if v["summary_fields_off"]}
            if off:
                raise AssertionError(f"device-route summaries leave the host's tolerance: {off}")
            # each group's device pass alone on uploaded volumes, min of 2, and
            # the device route's peak memory above what the smoke holds
            from braintpu_torch.features import devstats
            from braintpu_torch.features.context import brain_mask_from

            vols = load_case_volumes(case200)[0]
            mods = {m: vols[i] for i, m in enumerate(("t1", "t1ce", "t2", "flair"))}
            labels = np.round(nifti.load(seg200).get_fdata(dtype="float32")).astype("int32")
            brain, wt = brain_mask_from(mods["t1"]), labels > 0
            passes = {
                "stats": lambda dv: devstats.compute_case_stats(mods, labels, brain, dev=dv),
                "mass": lambda dv: devstats.compute_mass_effect_stats(mods["t1"], wt, brain, dev=dv),
                "morph": lambda dv: devstats.compute_morphology_stats(mods["t1ce"], wt, dev=dv),
                "artifacts": lambda dv: devstats.compute_artifact_stats(mods, brain, wt, dev=dv),
                "parenchyma": lambda dv: devstats.compute_parenchyma_stats(
                    mods["t1"], mods["flair"], brain, wt, dev=dv)}
            secs = {k: [] for k in ("upload", *passes)}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                t0 = time.perf_counter()
                dv = devstats.DeviceVolumes(mods, labels, brain, device="cuda").block_until_uploaded()
                secs["upload"].append(time.perf_counter() - t0)
                for g, fn in passes.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(dv)
                    torch.cuda.synchronize()
                    secs[g].append(time.perf_counter() - t0)
                del dv
            print(json.dumps({"feature_passes": {
                "s_min": {k: min(v) for k, v in secs.items()}, "s": secs,
                "peak_bytes_above_start": torch.cuda.max_memory_allocated() - base,
                "note": "host clock around each compute_* call on resident volumes, synchronised; "
                        "upload = DeviceVolumes (stack, int16 check, pinning, copy) until its "
                        "event"}}), flush=True)
            torch.cuda.empty_cache()

        with phase("13b cli segment --trace-dir as a process, then cli profile-report"):
            trace_dir = tmp / "trace13"
            cli_env = {**os.environ, "GEMINI_API_KEY": ""}
            out = subprocess.run(
                [sys.executable, "-u", "-m", "braintpu_torch.cli", "segment", "--input",
                 str(flagship), "--output", str(tmp / "out13"), "--checkpoints", str(root),
                 "--models", "model1,model2", "--folds", "2", "--random-weights",
                 "--trace-dir", str(trace_dir)],
                cwd=ROOT, capture_output=True, text=True, timeout=600, env=cli_env)
            if out.returncode != 0 or "capturing device trace to" not in out.stdout:
                raise AssertionError(f"cli segment --trace-dir: {out.returncode}\n"
                                     f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            reports = {}
            for line, top in (("XLA Ops", 1000), ("XLA Modules", 12)):
                rep = subprocess.run(
                    [sys.executable, "-m", "braintpu_torch.cli", "profile-report",
                     str(trace_dir), "--line", line, "--top", str(top)],
                    cwd=ROOT, capture_output=True, text=True, timeout=300, env=cli_env)
                if rep.returncode != 0:
                    raise AssertionError(f"profile-report --line {line!r}: {rep.returncode}\n"
                                         f"{rep.stderr[-2000:]}")
                reports[line] = rep.stdout.splitlines()
            named = {k: any(k in ln for ln in reports["XLA Ops"])
                     for k in ("conv_stage_kernel", "conv3d_tap_merged_kernel", "upconv2x_kernel")}
            print(json.dumps({"profile_report": {
                "segment_output": out.stdout.strip().splitlines()[-3:],
                "trace_files": [t.name for t in traces],
                "trace_bytes": [t.stat().st_size for t in traces],
                "kernels_named": named, "xla_ops_head": reports["XLA Ops"][:14],
                "xla_ops_total": reports["XLA Ops"][-1],
                "xla_modules_head": reports["XLA Modules"]}}), flush=True)
            if not all(named.values()):
                raise AssertionError(f"profile-report does not name every kernel: {named}")

        with phase("13c cli visualize and compare (seed 200); resize on the card vs the CPU"):
            viz = tmp / "viz13"
            import importlib.util

            if importlib.util.find_spec("matplotlib") is None:
                # the figures are host work: tests/test_torch_utils.py holds
                # them (and the overlay arrays) to the reference
                print("# cut: visualize and compare draw with matplotlib, which this machine "
                      "lacks; the smoke checks that both stop with a message and holds "
                      "create_rgb_overlay on seed 200 instead")
                for argv in (["visualize", "--input", str(flagship), "--segmentation",
                              str(seg200), "--output", str(viz)],
                             ["compare", "--gt", str(case200.seg_path), "--pred", str(seg200),
                              "--output", str(viz / "compare.png")]):
                    try:
                        cli_main(argv)
                        raise AssertionError(f"{argv[0]} ran without matplotlib")
                    except SystemExit as e:
                        if "matplotlib" not in str(e):
                            raise
                from braintpu_torch.viz import create_rgb_overlay

                z = int(np.argmax((nifti.load(seg200).get_fdata(dtype="float32") > 0)
                                  .sum(axis=(0, 1))))
                t1 = load_case_volumes(case200)[0][0]
                ov = create_rgb_overlay(t1[:, :, z], nifti.load(seg200).get_fdata(
                    dtype="float32")[:, :, z])
                if ov.shape != t1.shape[:2] + (3,) or not np.isfinite(ov).all() \
                        or not (0 <= ov.min() <= ov.max() <= 1):
                    raise AssertionError(f"overlay of seed 200 z={z}: {ov.shape}")
                pngs = []
            else:
                rc_v = cli_main(["visualize", "--input", str(flagship), "--segmentation",
                                 str(seg200), "--output", str(viz)])
                rc_c = cli_main(["compare", "--gt", str(case200.seg_path), "--pred", str(seg200),
                                 "--output", str(viz / "compare.png"), "--background",
                                 str(case200.modality_paths["flair"])])
                pngs = sorted(viz.glob("*.png"))
                bad = [p.name for p in pngs if p.read_bytes()[:4] != b"\x89PNG"]
                if rc_v or rc_c or len(pngs) != 6 or bad:
                    raise AssertionError(f"visualize / compare: rc {rc_v} {rc_c}, "
                                         f"{[p.name for p in pngs]}, not PNG {bad}")
            from braintpu_torch.pre import resize_nearest, resize_trilinear

            vol = load_case_volumes(case200)[0]  # (4, 240, 240, 155) f32
            labels = nifti.load(seg200).get_fdata(dtype="float32").astype("int32")
            rs = {}
            for new in ((160, 160, 103), (288, 288, 186)):
                cpu = resize_trilinear(vol, new, device="cpu")
                t0 = time.perf_counter()
                resize_trilinear(vol, new, device="cpu")
                cpu_s = time.perf_counter() - t0
                card = resize_trilinear(vol, new, device="cuda")
                err = (card.cpu() - cpu).abs().max().item()
                tol = 1e-5 * cpu.abs().max().item()
                vol_d = torch.from_numpy(vol).cuda()
                card_ms = cuda_ms(torch, lambda: resize_trilinear(vol_d, new, device="cuda"))
                near = resize_nearest(labels, new, device="cuda").cpu()
                near_eq = bool(torch.equal(near, resize_nearest(labels, new, device="cpu")))
                nbytes = vol.nbytes + 4 * vol.shape[0] * new[0] * new[1] * new[2]
                rs["x".join(map(str, new))] = {
                    "max_abs_err": err, "tol": tol, "card_ms": card_ms, "cpu_s": cpu_s,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "nearest_bit_equal": near_eq}
                if not err <= tol or not near_eq:
                    raise AssertionError(f"resize on the card vs the CPU at {new}: {err} > {tol} "
                                         f"or nearest not equal ({near_eq})")
            print(json.dumps({"visualize_compare": [p.name for p in pngs], "resize": rs}),
                  flush=True)

        # parallelism across devices, on the one card (phase 14)
        torch.cuda.empty_cache()
        sharded = sharded_phases(torch, np, flagship, root, tmp,
                                 (tap_layers, stage_layers, up_layers, MODEL2_GN_LARGE),
                                 pair_dirs=(brats_size, pair))

        with phase("15 closing surface on the card (seed 200)"):
            torch.cuda.empty_cache()
            closing_surface(torch, np, flagship, seg200)

        with phase("16 conv_impl on the card (seed 200, 240x240x155)"):
            torch.cuda.empty_cache()
            impl_runs = conv_impl_phase(torch, flagship, root, tmp,
                                        (tap_layers, stage_layers, up_layers))

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
            "launches_sliding": sliding_counts[name],
            "launches_serving": served_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "shape": h["shape"], "ms": h["kernel_ms"], "device_ms": h.get("device_ms"),
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"],
            "launches_train_step": {m: train_results[m].get("launches", {}).get(name, 0)
                                    / train_results[m].get("steps_timed", 1)
                                    for m in (*TRAIN_MODELS, "axial")},
            "launches_axial_sliding": {m: c[name] for m, c in axial_counts.items()},
            "launches_batched": batched_launches[name],
            "launches_sharded": {
                "one_nccl_rank_mirror": sharded["14a"]["mirror"]["launches"][name],
                "one_nccl_rank_spatial": sharded["14a"]["spatial"]["launches"][name],
                "mirror_per_rank": [lk[name] for lk in sharded["14b"]["launches_per_rank"]],
                "spatial_model1_per_rank": [p["launches"][name]
                                            for p in sharded["14c"]["model1"]["per_rank"]],
                "spatial_model2_per_rank": [p["launches"][name]
                                            for p in sharded["14c"]["model2"]["per_rank"]],
                "dp_train_2_steps_per_rank": [lk[name] for lk in
                                              sharded["14d"]["launches_per_rank_timed"]],
                "patch_runner_per_rank": [lk[name] for lk in
                                          sharded["14e"]["patch_runner_launches_per_rank"]],
                "segment_spatial_shard_per_rank": [
                    lk[name] for lk in sharded["14f"]["seg_spatial"]["launches_per_rank"]],
                "segment_batched_per_rank": [
                    lk[name] for lk in sharded["14f"]["seg_batched"]["launches_per_rank"]],
                "dryrun_rank0": sharded["14e"]["dryrun"]["launches"][name]},
            "sharded_launch_keys_checked": {
                k: v for k, v in sharded["14g"][name].items() if k != "launch_keys"},
            **({"out_planes_check": stage_window} if name == "conv_stage" else {}),
            "launches_conv_impl": {impl: impl_runs[impl]["launches_per_case"][name]
                                   for impl in CONV_IMPLS},
        })
    cube = next(r for r in int8_records if r["probe"] == "int8:4096cube")
    line.append({
        "name": "int8_matmul", "route": "cuda", "source": "braintpu_torch/csrc/int8_matmul.cu",
        "replaces": "braintpu/ops/int8_probe.py:59",
        "replaces_function": "braintpu/ops/int8_probe.py::int8_matmul", "checked": True,
        "launches": int8_launches, "launches_on_main_path": 0, "launches_serving": int8_served,
        "launches_path": "python -m braintpu_torch.tools.probe int8",
        "max_abs_err": max(r["max_abs_err"] for r in int8_records),
        "shape": cube["shape"], "ms": cube["kernel_ms"], "device_ms": cube["device_ms"],
        "int8_route": cube["route"], "plain_ms": cube["plain_ms"],
        "bound_ms": cube["bound_ms"], "bound_by": cube["bound_by"],
        "library_ms": cube["library_ms"], "library": cube["library"],
        "library_rowmajor_ms": cube["library_rowmajor_ms"],
        "library_colmajor_ms": cube["library_colmajor_ms"],
    })
    print(f"# total wall: {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
