"""Modular 3D U-Net: a decoupled encoder and decoder with per-stage plans.

Counterpart of ``braintpu/models/modular_unet.py``: every stage has its own
pool kernel (anisotropic allowed; ``(1, 1, 1)`` for none), conv kernel and
block count, as nnU-Net's experiment planner writes them.  The encoder
returns the per-stage skips (bottleneck last) and the decoder consumes
them, so either half can be reused.  Pooling is the first conv of a stage
(strided), upsampling a stride-k transposed conv.

The blocks are :mod:`.unet3d`'s (``_block_apply``, ``_upconv``,
``_seg_head``) through a per-stage :class:`~.unet3d.UNetConfig` shim, so the
dispatch is the same: a bf16 stride-1 3x3x3 conv in the band (``48 <= D <
96``, ``co >= 64``) goes to the Hopper tap kernel without LeakyReLU (the norm
sits between the conv and the activation), a bf16 2x2x2 up-conv to
``upconv2x``; anisotropic kernels and strides take the library.  Random
initialisation draws from a numpy Generator (the reference splits
random keys of its own, so the values differ; the tests carry the reference's
parameters across).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .unet3d import UNetConfig, _block_apply, _he_init, _seg_head, _upconv

__all__ = [
    "ModularUNetConfig",
    "REFERENCE_3D",
    "stage_features",
    "init_encoder",
    "apply_encoder",
    "init_decoder",
    "apply_decoder",
    "init_modular_unet",
    "apply_modular_unet",
    "estimate_activation_bytes",
]

Triple = Tuple[int, int, int]


@dataclass(frozen=True)
class ModularUNetConfig:
    """Static per-stage architecture plan (the reference's fields)."""

    in_channels: int = 4
    num_classes: int = 3
    base_features: int = 32
    max_features: int = 480
    feat_map_mul: int = 2
    #: stage 0's pool applies before its convs; (1, 1, 1) = no pooling
    pool_kernels: Tuple[Triple, ...] = (
        (1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
    conv_kernels: Tuple[Triple, ...] = ((3, 3, 3),) * 6
    blocks_per_stage_encoder: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)
    #: one stage fewer than the encoder (the bottleneck is the encoder's);
    #: None mirrors the encoder
    blocks_per_stage_decoder: Optional[Tuple[int, ...]] = None
    norm: str = "instance"
    #: GroupNorm groups (norm="group"): every stage width must be a multiple
    group_norm_groups: int = 8
    negative_slope: float = 0.01
    compute_dtype: torch.dtype = torch.bfloat16
    #: the dtype :func:`init_modular_unet` draws its leaves at
    param_dtype: torch.dtype = torch.float32
    final_nonlin: str = "softmax"

    def __post_init__(self):
        if not (len(self.pool_kernels) == len(self.conv_kernels)
                == len(self.blocks_per_stage_encoder)):
            raise ValueError("per-stage plans must have equal length")
        if (self.blocks_per_stage_decoder is not None
                and len(self.blocks_per_stage_decoder) != self.num_stages - 1):
            raise ValueError("blocks_per_stage_decoder needs one entry per stage but the last")
        if self.norm == "group":
            bad = [f for f in stage_features(self) if f % self.group_norm_groups]
            if bad:
                raise ValueError(
                    f"stage feature counts {bad} are not multiples of "
                    f"group_norm_groups={self.group_norm_groups}; pick a group count that "
                    "divides every stage width")

    @property
    def num_stages(self) -> int:
        return len(self.pool_kernels)

    def decoder_blocks(self) -> Tuple[int, ...]:
        if self.blocks_per_stage_decoder is not None:
            return self.blocks_per_stage_decoder
        return tuple(self.blocks_per_stage_encoder[:-1][::-1])

    def block_cfg(self, kernel: Triple) -> UNetConfig:
        """Per-stage shim for the :mod:`.unet3d` blocks."""
        return UNetConfig(norm=self.norm, group_norm_groups=self.group_norm_groups,
                          negative_slope=self.negative_slope, compute_dtype=self.compute_dtype,
                          param_dtype=self.param_dtype, conv_kernel=tuple(kernel))


def stage_features(cfg: ModularUNetConfig) -> List[int]:
    return [min(cfg.base_features * cfg.feat_map_mul**s, cfg.max_features)
            for s in range(cfg.num_stages)]


#: The reference's 3D memory-budget configuration (patch 160x128x128,
#: 32 -> 512 features).
REFERENCE_3D = ModularUNetConfig(max_features=512)


def _init_block(rng: np.random.Generator, cin: int, cout: int, kernel: Triple,
                cfg: ModularUNetConfig) -> Dict[str, torch.Tensor]:
    dt = cfg.param_dtype
    block = {"w": _he_init(rng, (*kernel, cin, cout), cfg.negative_slope).to(dt),
             "b": torch.zeros(cout, dtype=dt), "scale": torch.ones(cout, dtype=dt),
             "shift": torch.zeros(cout, dtype=dt)}
    if cfg.norm == "batch":
        block["mean"] = torch.zeros(cout, dtype=dt)
        block["var"] = torch.ones(cout, dtype=dt)
    return block


def init_encoder(cfg: ModularUNetConfig, rng: np.random.Generator) -> List[List[Dict]]:
    """Per-stage lists of conv blocks; stage s downsamples by pool_kernels[s]."""
    feats = stage_features(cfg)
    stages = []
    cin = cfg.in_channels
    for s in range(cfg.num_stages):
        stages.append([_init_block(rng, cin if c == 0 else feats[s], feats[s],
                                   cfg.conv_kernels[s], cfg)
                       for c in range(cfg.blocks_per_stage_encoder[s])])
        cin = feats[s]
    return stages


def apply_encoder(params: Sequence[Sequence[Dict]], x: torch.Tensor,
                  cfg: ModularUNetConfig) -> List[torch.Tensor]:
    """(N, D, H, W, C) -> the per-stage skips, bottleneck last."""
    skips = []
    h = x
    for s, blocks in enumerate(params):
        bc = cfg.block_cfg(cfg.conv_kernels[s])
        for c, block in enumerate(blocks):
            stride = tuple(cfg.pool_kernels[s]) if c == 0 else (1, 1, 1)
            h, _ = _block_apply(h, block, bc, stride, False, False)
        skips.append(h)
    return skips


def init_decoder(cfg: ModularUNetConfig, rng: np.random.Generator) -> List[Dict]:
    """One stage per encoder skip below the bottleneck (deepest first)."""
    feats = stage_features(cfg)
    dec_blocks = cfg.decoder_blocks()
    stages = []
    n = cfg.num_stages - 1
    for i, s in enumerate(range(n - 1, -1, -1)):
        below, skip = feats[s + 1], feats[s]
        up_w = _he_init(rng, (below, *cfg.pool_kernels[s + 1], skip),
                        cfg.negative_slope).to(cfg.param_dtype)
        blocks = [_init_block(rng, 2 * skip, skip, cfg.conv_kernels[s], cfg)]
        for _ in range(dec_blocks[i] - 1):
            blocks.append(_init_block(rng, skip, skip, cfg.conv_kernels[s], cfg))
        seg_w = _he_init(rng, (1, 1, 1, skip, cfg.num_classes),
                         cfg.negative_slope).to(cfg.param_dtype)
        stages.append({"up": {"w": up_w}, "blocks": blocks, "seg": {"w": seg_w}})
    return stages


def apply_decoder(params: Sequence[Dict], skips: Sequence[torch.Tensor], cfg: ModularUNetConfig,
                  deep_supervision: bool = False):
    """Skips (bottleneck last) -> f32 logits of the full-resolution head, or
    every head (full resolution first) with ``deep_supervision``."""
    h = skips[-1]
    heads = []
    n = cfg.num_stages - 1
    for i, stage in enumerate(params):
        s = n - 1 - i  # the encoder stage whose skip this stage takes
        bc = cfg.block_cfg(cfg.conv_kernels[s])
        h = torch.cat([_upconv(h, stage["up"]["w"], cfg.compute_dtype), skips[s]], dim=-1)
        for block in stage["blocks"]:
            h, _ = _block_apply(h, block, bc, (1, 1, 1), False, False)
        heads.append(_seg_head(h, stage["seg"]["w"], cfg.compute_dtype))
    if deep_supervision:
        return [heads[-1]] + heads[:-1][::-1]
    return heads[-1]


def init_modular_unet(cfg: ModularUNetConfig, seed: int) -> Dict[str, Any]:
    """Random parameters at ``cfg.param_dtype`` from an int seed (one numpy
    Generator, the encoder drawn before the decoder; each He leaf drawn in
    f32 and cast, as the reference's)."""
    rng = np.random.default_rng(int(seed))
    return {"encoder": init_encoder(cfg, rng), "decoder": init_decoder(cfg, rng)}


def apply_modular_unet(params: Dict[str, Any], x: torch.Tensor, cfg: ModularUNetConfig,
                       deep_supervision: bool = False):
    """Eval-mode forward (norms with their running or per-sample statistics)."""
    skips = apply_encoder(params["encoder"], x, cfg)
    return apply_decoder(params["decoder"], skips, cfg, deep_supervision)


def estimate_activation_bytes(cfg: ModularUNetConfig, patch_size: Triple, batch: int = 1) -> int:
    """Approximate peak activation bytes of one forward: the stage feature
    maps (encoder blocks; decoder concat and blocks) at the compute dtype
    (the reference's estimator)."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    feats = stage_features(cfg)
    shape = np.asarray(patch_size, np.int64)
    total = 0
    shapes = []
    for s in range(cfg.num_stages):
        shape = shape // np.asarray(cfg.pool_kernels[s])
        shapes.append(shape.copy())
        total += int(shape.prod()) * feats[s] * cfg.blocks_per_stage_encoder[s]
    dec_blocks = cfg.decoder_blocks()
    for i, s in enumerate(range(cfg.num_stages - 2, -1, -1)):
        total += int(shapes[s].prod()) * feats[s] * (2 + dec_blocks[i])  # concat + blocks
    return total * batch * itemsize
