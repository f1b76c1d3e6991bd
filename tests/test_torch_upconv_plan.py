"""The launch plan of the persistent up-conv kernel (``ops/upconv_plan.py``)
and a plain PyTorch walk of it.

On the CPU: every up-conv shape of both models in the three buckets gets a
plan the kernel can take (shared memory within the card's limit, a ring
whose stages each serve one consumer, column groups of equal size), the
schedule covers every (row tile, phase pair, column slice) of the output
exactly once, and a walk of the plan -- tile by tile, slice by slice, each
slice's result written into the lanes view of the output and clipped at
its bounds -- reproduces the plain version at ragged shapes.  On the card
(marker ``gpu``): the kernel against its plain version at every main-path
shape and at the ragged ones.

This file imports no JAX: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_upconv_plan.py`` runs its card-only tests where JAX is
absent.  ``tests/test_torch_upconv_parity.py`` holds the walk against the
Pallas kernel.
"""

import math
import re

import numpy as np
import pytest
import torch

from braintpu_torch.models.unet3d import MODEL1_BN, MODEL2_GN_LARGE, upconv_layers
from braintpu_torch.ops import _build
from braintpu_torch.ops import upconv as upconv_mod
from braintpu_torch.ops import upconv_plan as up
from braintpu_torch.ops.upconv import upconv2x, upconv2x_ref, upconv_supported
from braintpu_torch.ops.upconv_plan import SMEM_LIMIT, SMS, upconv_plan, upconv_plan_smem_bytes

BUCKETS = [(128, 128, 96), (192, 192, 128), (224, 224, 128)]


def _layers():
    return [(tuple(s), co) for b in BUCKETS for cfg in (MODEL1_BN, MODEL2_GN_LARGE)
            for s, co in upconv_layers(cfg, b)]


MAIN_PATH = sorted(set(_layers()))


def _sid(case):
    shape, co = case
    return f"{'x'.join(map(str, shape))}-{co}"


def test_main_path_has_the_two_models_up_convs():
    # 5 up-convs per forward, two models, three buckets; model 1 and model 2
    # share the deepest one in every bucket
    assert len(_layers()) == 30
    assert len(MAIN_PATH) == 27
    assert all(upconv_supported(s, co) for s, co in MAIN_PATH)


def schedule(plan, N, D, H, W):
    """What each block does, as the kernel walks it: for block b, its
    column group and its tiles, each with the consumer warpgroup that
    takes it."""
    th, tw = math.ceil(H / plan.bh), math.ceil(W / plan.bw)
    assert plan.tiles == N * D * th * tw
    takers = 1 if plan.stream else up.NC
    blocks = []
    for b in range(plan.grid):
        grp, first = b % plan.splits, b // plan.splits
        cnt = plan.grid // plan.splits + (grp < plan.grid % plan.splits)
        tiles = []
        k = 0
        while first + k * cnt < plan.tiles:
            tiles.append((first + k * cnt, k % takers))
            k += 1
        blocks.append((grp, tiles))
    return blocks


def tile_box(plan, t, H, W):
    """(n*D + d, h0, w0) of tile t."""
    th, tw = math.ceil(H / plan.bh), math.ceil(W / plan.bw)
    nd, rem = divmod(t, th * tw)
    return nd, rem // tw * plan.bh, rem % tw * plan.bw


@pytest.mark.parametrize("case", MAIN_PATH, ids=_sid)
def test_plan_of_every_main_path_shape(case):
    (N, D, H, W, ci), co = case
    plan = upconv_plan(N, D, H, W, ci, co)
    assert plan is not None and not plan.stream  # every model shape keeps B resident
    assert plan.smem_bytes == upconv_plan_smem_bytes(ci, plan.nb, plan.sg, plan.stages, False)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.bh * plan.bw <= up.ROWS and plan.bw == min(W, up.ROWS)
    assert plan.nb == (64 if 2 * co <= 64 else 128)
    assert plan.sp == math.ceil(2 * co / plan.nb)
    # equal column groups; a stage serves one consumer
    assert plan.splits * plan.sg == 4 * plan.sp
    assert 2 <= plan.stages <= 6 and plan.stages % up.NC == 0
    # at most one wave, and at least one block per group; the card is
    # filled wherever the tiles allow it
    assert plan.splits <= plan.grid <= SMS
    assert plan.grid == min(SMS, plan.splits * math.ceil(plan.tiles / up.NC))
    # fewest splits: the next smaller equal grouping does not fit 4 stages
    smaller = [s for s in range(1, plan.splits) if (4 * plan.sp) % s == 0]
    if plan.stages >= 4:
        assert all(up._stages(ci, plan.nb, 4 * plan.sp // s, False) < 4 for s in smaller)


@pytest.mark.parametrize("case", MAIN_PATH, ids=_sid)
def test_schedule_covers_every_tile_slice_once(case):
    (N, D, H, W, ci), co = case
    plan = upconv_plan(N, D, H, W, ci, co)
    seen = {}
    for grp, tiles in schedule(plan, N, D, H, W):
        for t, consumer in tiles:
            for gs in range(grp * plan.sg, (grp + 1) * plan.sg):
                key = (t, gs // plan.sp, gs % plan.sp)  # row tile, phase pair, N slice
                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == plan.tiles * 4 * plan.sp
    assert set(seen.values()) == {1}
    # the tiles cover every input voxel of every (n, d) slice once
    cover = np.zeros((N * D, H, W), np.int32)
    for t in range(plan.tiles):
        nd, h0, w0 = tile_box(plan, t, H, W)
        cover[nd, h0:h0 + plan.bh, w0:w0 + plan.bw] += 1
    assert (cover == 1).all()


# ---------------------------------------------------------------------------
# A plain walk of the plan
# ---------------------------------------------------------------------------


def walk(plan, x, w):
    """The kernel's arithmetic in f32, as the plan tiles it: for every block,
    tile and column slice, the 64-row A tile (zeros outside the volume and
    past ci, K padded to whole 64-channel chunks) times the slice's B columns
    (zeros past 8 co), each phase pair's run written into the lanes view
    (2co, W, 2, H, N*2D) of the output, clipped at its bounds.  Returns the
    output (N, 2D, 2H, 2W, co) f32 and how often each element was written."""
    N, D, H, W, ci = x.shape
    co = w.shape[-1]
    kc = math.ceil(ci / 64)
    a_all = torch.zeros(N * D, H + plan.bh, W + plan.bw, kc * 64)
    a_all[:, :H, :W, :ci] = x.float().reshape(N * D, H, W, ci)
    b_all = torch.zeros(kc * 64, 8 * co + plan.nb)
    b_all[:ci, :8 * co] = w.float().reshape(ci, 8 * co)
    # lanes view with room for the clipped overhang: (od, h, kh, w, run)
    lanes = torch.full((2 * N * D, H + plan.bh, 2, W + plan.bw, 2 * co + plan.nb), float("nan"))
    writes = torch.zeros(lanes.shape, dtype=torch.int32)
    for grp, tiles in schedule(plan, N, D, H, W):
        for t, _ in tiles:
            nd, h0, w0 = tile_box(plan, t, H, W)
            rows = a_all[nd, h0:h0 + plan.bh, w0:w0 + plan.bw].reshape(-1, kc * 64)
            a = torch.zeros(up.ROWS, kc * 64)
            a[:rows.shape[0]] = rows
            for gs in range(grp * plan.sg, (grp + 1) * plan.sg):
                ph, j0 = gs // plan.sp, gs % plan.sp * plan.nb
                col0 = ph * 2 * co + j0
                acc = a @ b_all[:, col0:col0 + plan.nb]  # 64 x nb, f32
                box = acc[:plan.bh * plan.bw].reshape(plan.bh, plan.bw, plan.nb)
                dst = (2 * nd + ph // 2, slice(h0, h0 + plan.bh), ph % 2,
                       slice(w0, w0 + plan.bw), slice(j0, j0 + plan.nb))
                lanes[dst] = box
                writes[dst] += 1
    # the output map's bounds: what lies past them was never stored
    lanes = lanes[:, :H, :, :W, :2 * co]
    writes = writes[:, :H, :, :W, :2 * co]
    y = lanes.reshape(N, 2 * D, H, 2, W, 2, co).reshape(N, 2 * D, 2 * H, 2 * W, co)
    return y, writes


def _inputs(N, D, H, W, ci, co, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, D, H, W, ci)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((ci, 2, 2, 2, co)) / np.sqrt(ci))
                         .astype(np.float32)).bfloat16()
    return x, w


def f32_upconv(x, w):
    N, D, H, W, ci = x.shape
    co = w.shape[-1]
    y = (x.float().reshape(-1, ci) @ w.float().reshape(ci, -1)).view(N, D, H, W, 2, 2, 2, co)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(N, 2 * D, 2 * H, 2 * W, co)


WALK = [
    (2, 3, 5, 3, 16, 8),      # W = 3, N = 2, co = 8: one ragged slice per run
    (1, 3, 7, 9, 24, 40),     # rows of 63, ragged H and ci, a run of 80 in a 128-slice
    (1, 2, 4, 3, 320, 320),   # deep: 5 slices per run, 20 column groups
    (2, 2, 3, 70, 64, 16),    # W > 64: W segments of 64 and 6
    (1, 2, 3, 5, 520, 24),    # ci too wide for resident B: the streamed mode
    (1, 3, 12, 12, 128, 128),  # 5 x 12 tiles, 4 groups of 2 slices
]


@pytest.mark.parametrize("shape", WALK, ids=lambda s: "x".join(map(str, s)))
def test_walk_of_the_plan_reproduces_the_plain_version(shape):
    N, D, H, W, ci, co = shape
    x, w = _inputs(N, D, H, W, ci, co, seed=sum(shape))
    plan = upconv_plan(N, D, H, W, ci, co)
    assert plan.stream == (ci == 520)
    y, writes = walk(plan, x, w)
    assert (writes == 1).all()  # every output element stored exactly once
    ref = f32_upconv(x, w)
    scale = ref.abs().max().item()
    assert torch.isfinite(y).all()
    assert (y - ref).abs().max().item() <= 1e-5 * scale
    # and the plain version the card is held to, in its own bf16
    plain = upconv2x_ref(x, w)
    assert (y.bfloat16().float() - plain.float()).abs().max().item() <= 0.02 * scale


def test_plan_refuses_what_the_kernel_does_not_take():
    assert upconv_plan(1, 2, 2, 2, 12, 8) is None  # ci % 8
    assert upconv_plan(1, 2, 2, 2, 16, 12) is None  # co % 8
    assert upconv_plan(0, 2, 2, 2, 16, 8) is None
    assert upconv_plan(2**20, 2**11, 2, 2, 16, 8) is None  # N*2D past a TMA coordinate


def test_the_launcher_takes_the_plan_in_its_order():
    # the launcher's argument block is the shape, then UpconvPlan.launch_args()
    src = (_build.CSRC / "upconv2x.cu").read_text()
    order = re.search(r"//\s+(N, D, H, W, ci, co, [a-z, ]+)\n", src).group(1).split(", ")
    assert order == ["N", "D", "H", "W", "ci", "co", "bh", "bw", "nb", "sg", "stages",
                     "streamed", "smem", "grid"]
    plan, args = upconv_mod._plan_args(1, 4, 8, 8, 64, 64)
    assert list(args) == [1, 4, 8, 8, 64, 64, plan.bh, plan.bw, plan.nb, plan.sg, plan.stages,
                          0, plan.smem_bytes, plan.grid]
    assert upconv_mod._plan_args(1, 4, 8, 8, 60, 64) == (None, None)
    # the constants the shared-memory formula shares with the kernel
    for name, value in (("ROWS", up.ROWS), ("NC", up.NC), ("BUFS", up.BUFS),
                        ("UP_MAX_STAGES", up.MAX_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "wgmma_ss<NB>" in src and "mma.sync" not in src
    assert "cp.async.bulk.tensor" in (_build.CSRC / "conv3d_wgmma.cuh").read_text()


# ---------------------------------------------------------------------------
# On the card only (marker ``gpu``)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_RAGGED = [(1, 3, 5, 7, 8, 8), (2, 2, 8, 9, 24, 40), (2, 3, 5, 3, 16, 8),
              (2, 2, 3, 70, 64, 16), (1, 2, 3, 5, 520, 24), (1, 7, 7, 4, 320, 320),
              (1, 3, 12, 12, 128, 128)]


def _gpu_check(cuda, N, D, H, W, ci, co):
    g = torch.Generator(device=cuda).manual_seed(N + D + H + W + ci + co)
    x = torch.randn(N, D, H, W, ci, device=cuda, generator=g).bfloat16()
    w = (torch.randn(ci, 2, 2, 2, co, device=cuda, generator=g) / ci ** 0.5).bfloat16()
    before = upconv2x.launches
    y = upconv2x(x, w)
    ref = upconv2x_ref(x, w)
    torch.cuda.synchronize()
    assert upconv2x.launches == before + 1
    assert (y.float() - ref.float()).abs().max().item() <= 0.02 * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", MAIN_PATH, ids=_sid)
def test_gpu_upconv_at_every_main_path_shape(cuda, case):
    (N, D, H, W, ci), co = case
    _gpu_check(cuda, N, D, H, W, ci, co)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_gpu_upconv_at_ragged_shapes(cuda, shape):
    _gpu_check(cuda, *shape)
