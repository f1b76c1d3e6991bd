"""The launch plan of the persistent up-conv kernel (``csrc/upconv2x.cu``).

:func:`upconv_plan` picks per shape what the kernel needs to know before a
launch; the wrapper passes it to the C launcher, which checks it again and
refuses (``cudaErrorInvalidValue``) a plan it cannot take.  It is an
internal choice per shape, not a user knob.

The GEMM is M = input voxels, K = ci, N = 8 co with column
``((kd*2 + kh)*2 + kw)*co + c``; for one phase pair ``(kd, kh)`` the ``2 co``
columns of a row are one contiguous run of the output.

* Tile: ``bh x bw`` input voxels of one ``(n, d)`` slice, at most 64 rows
  (one consumer warpgroup's wgmma m64): whole W rows when W <= 64
  (``bw = W``, ``bh = 64 // W`` rows of H), else a 64-voxel W segment.
  Ragged H and W edges are clipped by the tensor maps.
* Column slices: ``nb`` = 64 columns when ``2 co <= 64``, else 128, and
  ``sp = ceil(2 co / nb)`` slices per phase pair, 4 sp in all (the last
  slice of a run may overhang it; the store clips the overhang).
* Resident weights: a block keeps the B columns of ``sg`` slices in shared
  memory for every tile it owns; ``splits = 4 sp / sg`` column groups of
  equal size share the tiles, so x is read ``splits`` times (once when the
  whole B fits).  The plan takes the fewest splits that leave room for a
  ring of at least 4 A stages (whole tiles, every 64-channel chunk of ci),
  else at least 2.
* Streamed weights: where not even one slice fits beside two A stages
  (ci > 512 or so, no model has it) each ring stage holds one 64-channel
  chunk of A and of one slice's B, and one consumer warpgroup takes the
  tiles.
* Grid: one block per SM (the plans use most of the SM's shared memory),
  persistent: ``min(132, splits x ceil(tiles / consumers))`` blocks and at
  least one per column group; block b serves group ``b % splits``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

__all__ = ["UpconvPlan", "upconv_plan", "upconv_plan_smem_bytes", "ROWS", "NC", "SMS",
           "SMEM_LIMIT"]

ROWS = 64             # input voxels per tile: one wgmma m64
KC = 64               # channels per K chunk: 128-byte rows
CHUNK = ROWS * 2 * KC  # bytes of one tile's 64-channel chunk
NC = 2                # consumer warpgroups
BUFS = 2              # staging buffers per consumer warpgroup
MAX_STAGES = 6
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
ALIGN_SLACK = 1024    # the kernel aligns its dynamic shared memory up to 1024
SMS = 132             # streaming multiprocessors of an H100 SXM


@dataclass(frozen=True)
class UpconvPlan:
    bh: int
    bw: int
    nb: int        # columns per slice
    sp: int        # slices per phase pair
    sg: int        # slices per column group (resident B)
    splits: int    # column groups
    stages: int
    stream: bool   # B streamed with A instead of resident
    smem_bytes: int
    tiles: int
    grid: int

    def launch_args(self) -> Tuple[int, ...]:
        """The plan as the C launcher takes it."""
        return (self.bh, self.bw, self.nb, self.sg, self.stages, int(self.stream),
                self.smem_bytes, self.grid)

    def describe(self) -> str:
        return (f"tile {self.bh}x{self.bw} nb {self.nb}x{4 * self.sp} "
                f"{'streamed' if self.stream else f'groups {self.splits}x{self.sg}'} "
                f"stages {self.stages} smem {self.smem_bytes} tiles {self.tiles} grid {self.grid}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def upconv_plan_smem_bytes(ci: int, nb: int, sg: int, stages: int, stream: bool) -> int:
    """Dynamic shared memory of a plan (``smem_bytes`` in the kernel):
    alignment slack, two staging buffers of 64 rows x ``nb`` bf16 per
    consumer warpgroup, a full and an empty barrier per stage and one for
    the resident weights, and either the resident B of ``sg`` slices plus
    ``stages`` whole A tiles, or ``stages`` (A chunk + B chunk) pairs."""
    kc = _cdiv(ci, KC)
    b = ALIGN_SLACK + BUFS * NC * nb * 128 + (2 * stages + 1) * 8
    if stream:
        return b + stages * (CHUNK + nb * 128)
    return b + sg * kc * nb * 128 + stages * kc * CHUNK


def _stages(ci: int, nb: int, sg: int, stream: bool) -> int:
    """The deepest ring that fits.  With resident B a multiple of NC: the
    consumers take tiles in turn, so each stage then serves one consumer,
    whose waits on its barriers come in order (with a stage shared by two
    consumers, a parity wait could pass on the phase before the one it
    waits for)."""
    kc = _cdiv(ci, KC)
    per = CHUNK + nb * 128 if stream else kc * CHUNK
    room = SMEM_LIMIT - upconv_plan_smem_bytes(ci, nb, sg, 0, stream) - 2 * MAX_STAGES * 8
    stages = min(MAX_STAGES, room // per)
    return stages if stream else stages - stages % NC


@lru_cache(maxsize=None)
def upconv_plan(N: int, D: int, H: int, W: int, ci: int, co: int) -> Optional[UpconvPlan]:
    """The plan of one ``(N, D, H, W, ci) -> co`` call, or None for a shape
    the kernel does not take (the wrapper raises then).  Cached: a forward
    asks for the same few shapes on every launch."""
    if min(N, D, H, W, ci, co) <= 0 or ci % 8 or co % 8 or 2 * N * D > 2**31 - 1:
        return None
    nb = 64 if 2 * co <= 64 else 128
    sp = _cdiv(2 * co, nb)
    slices = 4 * sp
    bw = min(W, ROWS)
    bh = min(H, ROWS // bw)
    tiles = N * D * _cdiv(H, bh) * _cdiv(W, bw)
    choice = None
    for least in (4, 2):
        for splits in range(1, slices + 1):
            if slices % splits:
                continue  # groups of equal size: no group holds a block up
            sg = slices // splits
            stages = _stages(ci, nb, sg, False)
            if stages >= least:
                choice = (sg, splits, stages, False)
                break
        if choice:
            break
    if choice is None:
        stages = _stages(ci, nb, 1, True)
        if stages < 2:
            return None
        choice = (1, slices, stages, True)
    sg, splits, stages, stream = choice
    grid = max(splits, min(SMS, splits * _cdiv(tiles, 1 if stream else NC)))
    if tiles > 2**31 - 1:
        return None
    return UpconvPlan(bh, bw, nb, sp, sg, splits, stages, stream,
                      upconv_plan_smem_bytes(ci, nb, sg, stages, stream), tiles, grid)
