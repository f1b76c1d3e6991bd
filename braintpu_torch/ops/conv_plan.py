"""The launch plan of the two 3x3x3 convolution kernels on their shared
Hopper main loop (``csrc/conv3d_wgmma.cuh``).

One function, :func:`conv_plan`, picks per shape what the kernels of
``csrc/conv3d_tap_merged.cu`` and ``csrc/conv_stage.cu`` need to know
before a launch, and both wrappers pass it to their launchers, whose C side
checks it again and refuses (``cudaErrorInvalidValue``) a plan it cannot
take.  It is an internal choice per shape, not a user knob.

* Output tile: a box ``bd x bh x bw`` of ``bm`` output voxels inside one
  sample, 64 rows per consumer warpgroup: ``bm`` = 256 (four) when
  ``bn <= 64``, where a taller tile reads each B tile for more rows, else
  128 (two); it drops a step while the taller tiles would give fewer
  blocks than the card has SMs (the deep levels, down to 64 rows).  The
  box minimises the voxels its tiles pad (ragged boxes are masked at the
  store), then prefers wide boxes.
* Columns: ``bn`` follows ``co``: the smallest of 32, 64, 128, 160, 256
  that covers it, and for ``co > 256`` column tiles of 160 (two at
  ``co = 320``) or 256.
* Stages: as many ring stages of one A tile (``bm`` rows x 128 bytes) and
  one B tile (``bn`` x 128 bytes) as fit in the block's shared memory next
  to the barriers and, for the stage kernel, its affine table and column
  sums; at most 6, at least 3.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

__all__ = ["ConvPlan", "conv_plan", "conv_plan_smem_bytes", "box_tiles", "SMS", "SMEM_LIMIT"]

KC = 64             # channels per K step (one tap, one input): 128-byte rows
ROW_BYTES = 2 * KC
BN_CHOICES = (32, 64, 128, 160, 256)
MAX_STAGES = 6
MIN_STAGES = 3
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
ALIGN_SLACK = 1024    # the kernel aligns its dynamic shared memory up to 1024
SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_BOX = 256         # a TMA box dimension


@dataclass(frozen=True)
class ConvPlan:
    bd: int
    bh: int
    bw: int
    bm: int
    bn: int
    col_tiles: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int]  # (box tiles x column tiles, samples)

    def launch_args(self) -> Tuple[int, ...]:
        """The plan as the C launchers take it."""
        return (self.bd, self.bh, self.bw, self.bm, self.bn, self.stages, self.smem_bytes)

    def describe(self) -> str:
        return (f"box {self.bd}x{self.bh}x{self.bw} bm {self.bm} bn {self.bn}x{self.col_tiles} "
                f"stages {self.stages} smem {self.smem_bytes} grid {self.grid[0]}x{self.grid[1]}")


def _chunks(ci: int) -> int:
    return -(-ci // KC)


def conv_plan_smem_bytes(bm: int, bn: int, stages: int, ci1: int, ci2: int, stage: bool) -> int:
    """Dynamic shared memory of a plan: alignment slack, the ring of A and B
    tiles, a full and an empty barrier per stage and, for the stage kernel,
    the affine table (a and c over each input's 64-channel chunks) and the
    block's column sums of y and y^2 (``smem_bytes`` in the header)."""
    b = ALIGN_SLACK + stages * (bm + bn) * ROW_BYTES + 2 * stages * 8
    if stage:
        b += (2 * KC * (_chunks(ci1) + _chunks(ci2)) + 2 * bn) * 4
    return b


def _columns(co: int) -> Tuple[int, int]:
    if co <= BN_CHOICES[-1]:
        return next(b for b in BN_CHOICES if b >= co), 1
    bn = 160 if co <= 320 else 256
    return bn, -(-co // bn)


def box_tiles(dims: Tuple[int, int, int], box: Tuple[int, int, int]) -> int:
    return (-(-dims[0] // box[0])) * (-(-dims[1] // box[1])) * (-(-dims[2] // box[2]))


def _box(D: int, H: int, W: int, bm: int) -> Tuple[int, int, int]:
    best = None
    p2 = [1 << i for i in range(bm.bit_length()) if (1 << i) <= bm]
    for bw in p2:
        for bh in p2:
            if bw * bh > bm:
                continue
            bd = bm // (bw * bh)
            if max(bd, bh, bw) > MAX_BOX:
                continue
            key = (box_tiles((D, H, W), (bd, bh, bw)), -bw, -bh)
            if best is None or key < best[0]:
                best = (key, (bd, bh, bw))
    return best[1]


@lru_cache(maxsize=None)
def conv_plan(N: int, D: int, H: int, W: int, ci1: int, co: int, ci2: int = 0,
              stage: bool = False) -> Optional[ConvPlan]:
    """The plan of one call: ``stage`` for ``conv_stage`` (two inputs,
    affine table, statistics), else ``conv3d_tap_merged``.  None when no
    plan fits (the wrappers raise then).  Cached: a forward asks for the
    same few shapes on every launch, and the box search costs host time."""
    if min(N, D, H, W, ci1, co) <= 0 or ci2 < 0:
        return None
    bn, col_tiles = _columns(co)
    plan = None
    for bm in ((256, 128, 64) if bn <= 64 else (128, 64)):
        bd, bh, bw = _box(D, H, W, bm)
        fixed = conv_plan_smem_bytes(bm, bn, 0, ci1, ci2, stage) + 2 * MAX_STAGES * 8
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // ((bm + bn) * ROW_BYTES))
        if stages < MIN_STAGES:
            continue
        blocks = box_tiles((D, H, W), (bd, bh, bw)) * col_tiles
        plan = ConvPlan(bd, bh, bw, bm, bn, col_tiles, stages,
                        conv_plan_smem_bytes(bm, bn, stages, ci1, ci2, stage), (blocks, N))
        if blocks * N >= SMS:
            break  # enough blocks of this height to fill the card
    if plan is None or plan.grid[0] > 2**31 - 1 or N > 65535:
        return None
    return plan
