"""The launch plan of the two wgmma convolution kernels (``ops/conv_plan.py``)
and a plain PyTorch walk of it.

On the CPU: every main-path conv shape of the three buckets gets a plan the
kernels can take (box of ``bm`` rows, shared memory within the card's
limit, columns covering ``co``, a grid that covers every output voxel
once), and a walk of the plan box by box, tap by tap and 64-channel chunk
by chunk -- zero-filled loads outside the volume and past ci, the K range
split at 27*ci1, the transform with the halo re-zeroed -- reproduces the
plain versions in f32 at ragged shapes.  On the card (marker ``gpu``): the
kernels against their plain versions at the shapes that stress the plan.

This file imports no JAX: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_conv_plan.py`` runs its card-only tests where JAX is absent.
"""

import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from braintpu_torch.models.unet3d import (MODEL1_BN, MODEL2_GN_LARGE, choose_impl,
                                          choose_stage_impl, conv_layers, deferred_layers)
from braintpu_torch.ops import conv3d as conv3d_mod
from braintpu_torch.ops import stage as stage_mod
from braintpu_torch.ops.conv3d import conv3d_tap_merged, conv3d_tap_merged_ref
from braintpu_torch.ops.conv_plan import (SMEM_LIMIT, SMS, ConvPlan, _box, box_tiles,
                                          conv_plan, conv_plan_smem_bytes)
from braintpu_torch.ops.stage import _transform, conv_stage, conv_stage_ref

BUCKETS = [(128, 128, 96), (192, 192, 128), (224, 224, 128)]


def _main_path_cases():
    cases = []
    for bucket in BUCKETS:
        for s, st, co in conv_layers(MODEL1_BN, bucket):
            if choose_impl(s, (3, 3, 3), st, co, MODEL1_BN.compute_dtype) == "kernel":
                cases.append(("tap", tuple(s), 0, co))
        for s, st, co, ci2 in deferred_layers(MODEL2_GN_LARGE, bucket):
            if choose_stage_impl(s, (3, 3, 3), st, co, ci2,
                                 MODEL2_GN_LARGE.compute_dtype) == "kernel":
                cases.append(("stage", tuple(s), ci2, co))
    return sorted(set(cases))


MAIN_PATH = _main_path_cases()


def _plan(kind, shape, ci2, co) -> ConvPlan:
    N, D, H, W, ci1 = shape
    plan = conv_plan(N, D, H, W, ci1, co, ci2, stage=kind == "stage")
    assert plan is not None, (kind, shape, ci2, co)
    return plan


def test_main_path_shapes_are_the_dispatch_s():
    # 3 tap layers per bucket at two distinct channel pairs; 15 stage layers
    # per bucket, of which the two deepest levels share shapes
    assert sum(k == "tap" for k, *_ in MAIN_PATH) == 6
    assert sum(k == "stage" for k, *_ in MAIN_PATH) == 42


@pytest.mark.parametrize("case", MAIN_PATH, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}+{c[2]}-{c[3]}")
def test_plan_of_every_main_path_shape(case):
    kind, shape, ci2, co = case
    N, D, H, W, ci1 = shape
    plan = _plan(kind, shape, ci2, co)
    assert plan.bd * plan.bh * plan.bw == plan.bm and plan.bm in (64, 128, 256)
    assert plan.bm < 256 or plan.bn <= 64
    assert max(plan.bd, plan.bh, plan.bw) <= 256
    assert 3 <= plan.stages <= 6
    assert plan.smem_bytes == conv_plan_smem_bytes(plan.bm, plan.bn, plan.stages, ci1, ci2,
                                                   kind == "stage")
    assert plan.smem_bytes <= SMEM_LIMIT
    # columns: one tile when co is one of the widths, else equal tiles that cover it
    assert plan.bn in (32, 64, 128, 160, 256)
    assert (plan.col_tiles - 1) * plan.bn < co <= plan.col_tiles * plan.bn
    if co in (32, 64, 128, 160, 256):
        assert (plan.bn, plan.col_tiles) == (co, 1)
    if co == 320:
        assert (plan.bn, plan.col_tiles) == (160, 2)
    # the grid covers every output voxel of every sample exactly once
    tiles = [math.ceil(d / b) for d, b in zip((D, H, W), (plan.bd, plan.bh, plan.bw))]
    assert plan.grid == (tiles[0] * tiles[1] * tiles[2] * plan.col_tiles, N)
    cover = np.zeros((D, H, W), np.int32)
    for z, y, x in itertools.product(*(range(t) for t in tiles)):
        cover[z * plan.bd:(z + 1) * plan.bd, y * plan.bh:(y + 1) * plan.bh,
              x * plan.bw:(x + 1) * plan.bw] += 1
    assert (cover == 1).all()
    # the tallest tile that still fills the card's SMs
    taller = [bm for bm in ((256, 128) if plan.bn <= 64 else (128,)) if bm > plan.bm]
    for bm in taller:
        assert box_tiles((D, H, W), _box(D, H, W, bm)) * plan.col_tiles * N < SMS
    assert plan.bm == 64 or plan.grid[0] * N >= SMS


# ---------------------------------------------------------------------------
# A plain walk of the plan
# ---------------------------------------------------------------------------


def walk(plan, x1, w, b, x2=None, a1=None, c1=None, a2=None, c2=None, in1_slope=None,
         in2_slope=None):
    """The kernels' arithmetic in f32, as the plan tiles it: returns the
    pre-activation y (N, D, H, W, co) f32 and the per-sample sums s1, s2
    over the rows each box holds inside the volume."""
    N, D, H, W, ci1 = x1.shape
    ci2 = 0 if x2 is None else x2.shape[-1]
    co = w.shape[-1]
    bd, bh, bw, bm, bn = plan.bd, plan.bh, plan.bw, plan.bm, plan.bn
    td, th, tw = (math.ceil(d / s) for d, s in zip((D, H, W), (bd, bh, bw)))
    oz, oy, ox = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(td) * bd, torch.arange(th) * bh, torch.arange(tw) * bw, indexing="ij"))
    r = torch.arange(bm)
    vd = oz[:, None] + r // (bw * bh)
    vh = oy[:, None] + (r // bw) % bh
    vw = ox[:, None] + r % bw
    inside = (vd < D) & (vh < H) & (vw < W)
    inputs = [(x1, ci1, 0, a1, c1, in1_slope)]
    if x2 is not None:
        inputs.append((x2, ci2, ci1, a2, c2, in2_slope))
    y = torch.full((N, D, H, W, co), float("nan"))
    s1 = torch.zeros(N, co)
    s2 = torch.zeros(N, co)
    for n in range(N):
        for ct in range(plan.col_tiles):
            n0 = ct * bn
            ncol = min(bn, co - n0)
            acc = torch.zeros(vd.shape[0], bm, bn)
            for tap in range(27):  # K: for each tap, x1's chunks, then x2's
                kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
                sd, sh, sw = vd + kd - 1, vh + kh - 1, vw + kw - 1
                ok = (sd >= 0) & (sd < D) & (sh >= 0) & (sh < H) & (sw >= 0) & (sw < W)
                for x, cik, off, a, c, slope in inputs:
                    for c0 in range(0, cik, 64):
                        nc = min(64, cik - c0)
                        # the TMA box: zeros outside the volume and past ci
                        tile = torch.zeros(vd.shape[0], bm, 64)
                        tile[..., :nc] = x[n, sd.clamp(0, D - 1), sh.clamp(0, H - 1),
                                           sw.clamp(0, W - 1), c0:c0 + nc].float()
                        tile[~ok] = 0.0
                        if a is not None or slope is not None:
                            av = torch.zeros(64)
                            cv = torch.zeros(64)
                            if a is not None:
                                av[:nc] = (a[n] if a.dim() == 2 else a)[c0:c0 + nc]
                                cv[:nc] = (c[n] if c.dim() == 2 else c)[c0:c0 + nc]
                                tile = tile * av + cv  # each op rounded in f32
                            if slope is not None:
                                tile = torch.where(tile >= 0, tile, tile * slope)
                            tile = tile.to(torch.bfloat16).float()
                            tile[~ok] = 0.0  # the halo stays zero after the transform
                        wt = torch.zeros(64, bn)
                        wt[:nc, :ncol] = w[kd, kh, kw, off + c0:off + c0 + nc, n0:n0 + ncol].float()
                        acc += tile @ wt
            v = acc[..., :ncol] + b[n0:n0 + ncol]
            y[n, vd[inside], vh[inside], vw[inside], n0:n0 + ncol] = v[inside]
            s1[n, n0:n0 + ncol] = v[inside].sum(0)
            s2[n, n0:n0 + ncol] = (v[inside] * v[inside]).sum(0)
    return y, s1, s2


def _stage_inputs(N, D, H, W, ci1, ci2, co, seed=0, per_sample=True):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x1 = t(N, D, H, W, ci1).bfloat16()
    x2 = t(N, D, H, W, ci2).bfloat16() if ci2 else None
    w = (t(3, 3, 3, ci1 + ci2, co) / (27 * (ci1 + ci2)) ** 0.5).bfloat16()
    b = t(co) * 0.1
    shp = (lambda ci: (N, ci)) if per_sample else (lambda ci: (ci,))
    aff = {"a1": t(*shp(ci1)).abs() + 0.5, "c1": t(*shp(ci1)) + 1.0}
    if ci2:
        aff.update(a2=t(*shp(ci2)).abs() + 0.5, c2=t(*shp(ci2)))
    return x1, x2, w, b, aff


def _f32_stage(x1, w, b, x2, aff, s1, s2):
    t = _transform(x1, aff.get("a1"), aff.get("c1"), s1)
    if x2 is not None:
        t = torch.cat([t, _transform(x2, aff.get("a2"), aff.get("c2"), s2)], dim=-1)
    return F.conv3d(t.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2), b,
                    padding=1).permute(0, 2, 3, 4, 1)


WALK_STAGE = [(1, 12, 14, 12, 72, 8, 32), (2, 6, 10, 9, 64, 0, 320), (2, 5, 9, 13, 24, 8, 40),
              (1, 3, 8, 9, 8, 0, 16)]


@pytest.mark.parametrize("shape", WALK_STAGE, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bm", ["plan", 128])
def test_walk_of_the_stage_plan_reproduces_the_plain_version(shape, bm):
    N, D, H, W, ci1, ci2, co = shape
    x1, x2, w, b, aff = _stage_inputs(N, D, H, W, ci1, ci2, co, seed=sum(shape))
    plan = conv_plan(N, D, H, W, ci1, co, ci2, stage=True)
    if bm == 128:  # a 128-row box on the same shape: raggeder still
        plan = ConvPlan(2, 8, 8, 128, plan.bn, plan.col_tiles, plan.stages, plan.smem_bytes,
                        plan.grid)
    slopes = dict(in1_slope=0.01, in2_slope=0.01 if ci2 else None)
    y, s1, s2 = walk(plan, x1, w, b, x2, **aff, **slopes)
    ref = _f32_stage(x1, w, b, x2, aff, slopes["in1_slope"], slopes["in2_slope"])
    scale = ref.abs().max().item()
    assert torch.isfinite(y).all()  # every voxel and channel written
    assert (y - ref).abs().max().item() <= 1e-5 * scale
    torch.testing.assert_close(s1, ref.sum((1, 2, 3)), rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(s2, (ref * ref).sum((1, 2, 3)), rtol=1e-4, atol=1e-4 * scale ** 2)
    # and the plain version the card is held to, in its own bf16
    ry, r1, r2 = conv_stage_ref(x1, w, b, x2=x2, **aff, **slopes, stats=True)
    assert (y.bfloat16().float() - ry.float()).abs().max().item() <= 0.02 * scale
    torch.testing.assert_close(s1, r1, rtol=1e-4, atol=1e-4 * scale)


WALK_TAP = [(1, 12, 14, 12, 72, 32), (1, 6, 10, 9, 64, 320), (1, 5, 9, 13, 24, 40),
            (2, 4, 8, 8, 8, 8)]


@pytest.mark.parametrize("shape", WALK_TAP, ids=lambda s: "x".join(map(str, s)))
def test_walk_of_the_tap_plan_reproduces_the_plain_version(shape):
    N, D, H, W, ci, co = shape
    x, _, w, b, _ = _stage_inputs(N, D, H, W, ci, 0, co, seed=sum(shape))
    plan = conv_plan(N, D, H, W, ci, co)
    y, _, _ = walk(plan, x, w, b)
    ref = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2), b,
                   padding=1).permute(0, 2, 3, 4, 1)
    scale = ref.abs().max().item()
    assert torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= 1e-5 * scale
    leaky = torch.where(y >= 0, y, y * 0.01).bfloat16().float()
    assert (leaky - conv3d_tap_merged_ref(x, w, b, 0.01).float()).abs().max().item() <= 0.02 * scale


def test_plan_refuses_what_no_kernel_takes():
    assert conv_plan(0, 4, 8, 8, 8, 8) is None
    assert conv_plan(70000, 4, 8, 8, 8, 8) is None  # grid.y holds the sample
    assert conv_plan(1, 4, 8, 8, 8, 0) is None


# ---------------------------------------------------------------------------
# On the card only (marker ``gpu``)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_STAGE = [
    (1, 12, 14, 12, 72, 8, 32),    # ragged box (H, W), ci off 64, co = 32
    (2, 6, 10, 9, 64, 0, 320),     # two column tiles of 160, per-sample affine
    (2, 5, 9, 13, 24, 8, 40),      # both inputs, per-sample affines, N = 2
    (2, 6, 10, 12, 64, 64, 64),    # both inputs at 64 channels, N = 2
    (1, 32, 32, 48, 64, 0, 64),    # a 256-row plan (four consumer warpgroups)
    (1, 24, 24, 32, 128, 0, 128),  # a 128-row plan
    (1, 8, 14, 14, 320, 320, 320),  # the deep decoder's shape, 64-row plan
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_STAGE, ids=lambda s: "x".join(map(str, s)))
def test_gpu_stage_kernel_at_the_plan_s_edges(cuda, shape):
    N, D, H, W, ci1, ci2, co = shape
    x1, x2, w, b, aff = _stage_inputs(N, D, H, W, ci1, ci2, co, seed=sum(shape))
    x1, w, b = x1.to(cuda), w.to(cuda), b.to(cuda)
    x2 = None if x2 is None else x2.to(cuda)
    aff = {k: v.to(cuda) for k, v in aff.items()}
    plan = conv_plan(N, D, H, W, ci1, co, ci2, stage=True)
    assert plan.bm == {(1, 32, 32, 48, 64, 0, 64): 256, (1, 24, 24, 32, 128, 0, 128): 128}.get(shape, 64)
    kw = dict(x2=x2, in1_slope=0.01, in2_slope=0.01 if ci2 else None, stats=True, **aff)
    before = conv_stage.launches
    y, s1, s2 = conv_stage(x1, w, b, **kw)
    ry, r1, r2 = conv_stage_ref(x1, w, b, **kw)
    torch.cuda.synchronize()
    assert conv_stage.launches == before + 1
    assert (y.float() - ry.float()).abs().max().item() <= 0.02 * ry.float().abs().max().item()
    sum_abs = conv_stage_ref(x1, w, b, **{**kw, "stats": False}).float().abs().sum((1, 2, 3))
    assert torch.all((s1 - r1).abs() <= 1e-3 * sum_abs)
    assert torch.all((s2 - r2).abs() <= 1e-3 * r2)


GPU_TAP = [(1, 12, 14, 12, 72, 32), (1, 6, 10, 9, 64, 320), (1, 5, 9, 13, 24, 40),
           (1, 24, 24, 32, 64, 64), (1, 32, 32, 48, 64, 64), (2, 14, 14, 8, 64, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_TAP, ids=lambda s: "x".join(map(str, s)))
def test_gpu_tap_kernel_at_the_plan_s_edges(cuda, shape):
    N, D, H, W, ci, co = shape
    x, _, w, b, _ = _stage_inputs(N, D, H, W, ci, 0, co, seed=sum(shape))
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    before = conv3d_tap_merged.launches
    y = conv3d_tap_merged(x, w, b, 0.01)
    ref = conv3d_tap_merged_ref(x, w, b, 0.01)
    torch.cuda.synchronize()
    assert conv3d_tap_merged.launches == before + 1
    assert (y.float() - ref.float()).abs().max().item() <= 0.02 * ref.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_wrappers_raise_on_a_plan_the_launcher_refuses(cuda, monkeypatch):
    def bad_plan(*args, **kwargs):
        p = conv_plan(*args, **kwargs)
        return ConvPlan(p.bd, p.bh, p.bw * 2, p.bm, p.bn, p.col_tiles, p.stages,
                        p.smem_bytes, p.grid)  # box != bm rows

    monkeypatch.setattr(conv3d_mod, "conv_plan", bad_plan)
    monkeypatch.setattr(stage_mod, "conv_plan", bad_plan)
    x, _, w, b, _ = _stage_inputs(1, 4, 8, 8, 16, 0, 16)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    before = (conv3d_tap_merged.launches, conv_stage.launches)
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        conv3d_tap_merged(x, w, b)
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        conv_stage(x, w, b)
    assert (conv3d_tap_merged.launches, conv_stage.launches) == before
