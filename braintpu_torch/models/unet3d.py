"""3D U-Net (nnU-Net KAIST BraTS-2021 topology) in PyTorch.

Counterpart of ``braintpu/models/unet3d.py``.  Parameters are the same
nested dicts (``encoder`` / ``bottleneck`` / ``decoder``) with the same
layouts -- channels-last activations (NDHWC), DHWIO conv kernels,
``(Ci,2,2,2,Co)`` up-convs -- so the tests hand both packages the same
arrays.  :func:`apply_unet` is a plain function over such a dict, and
:func:`init_params` draws the reference's random weights bit for bit.

Two inference forwards:

* **BatchNorm models** (MODEL1_BN) with the norm folded into the convs
  (:func:`fold_batchnorm`): Conv -> LeakyReLU blocks.  :func:`choose_impl`
  sends the layers the reference sends to its Pallas kernel -- stride-1
  3x3x3 convs with ``48 <= D < 96`` and ``co >= 64`` in a bf16 config -- to
  the hand-written Hopper kernel ``ops.conv3d.conv3d_tap_merged`` (bias and
  LeakyReLU fused), and every other conv to ``F.conv3d``.
* **GroupNorm / InstanceNorm models** (MODEL2_GN_LARGE) through the
  reference's deferred-norm path (``_apply_unet_fused``): tensors travel
  before normalization with a per-channel affine ``(a, c, slope)`` meaning
  ``leaky_slope(raw * a + c)``, which the next conv applies as it reads.
  :func:`choose_stage_impl` sends every stride-1 3x3x3 conv that the stage
  kernel takes in a bf16 config to ``ops.stage.conv_stage`` (input affines,
  skip concat, conv, per-sample statistics in one kernel); the rest (the
  first conv, the stride-2 pooling convs, an f32 config) materialize their
  input, run ``F.conv3d`` and take the statistics of the bf16 output.

Both forwards send their bf16 2x2x2 up-convs to the Hopper kernel
``ops.upconv.upconv2x`` and end in the 1x1x1 seg head (f32 logits).

That is the dispatch of ``conv_impl="auto"``, the default.  The config's
``conv_impl`` is the reference's switch between its hand-written conv
kernel and the library, and every conv of every forward below reads it
through :func:`resolve_conv_impl`: ``"pallas"`` sends every bf16 stride-1
3x3x3 conv the tap kernel takes to it, whatever its depth, and keeps the
deferred-norm path off ``conv_stage`` (its convs materialize their inputs
first); ``"xla3d"``, ``"decomp2d"`` and ``"merged2d"`` send every conv to
``F.conv3d``.  The up-convs do not read it, as in the reference.

The **axial families** (``AXIAL_UNET``, ``AXIAL_UNET_FULL``; BatchNorm
U-Nets with axial attention, :mod:`.axial`) run the blocks forward below
in every mode, folded or not: their convs take the same dispatch as
MODEL1_BN (the band on the tap kernel, LeakyReLU fused when folded), their
up-convs ``upconv2x``, and the attention sits where
:func:`attention_plan` puts it.  :func:`apply_unet` raises when a tree's
attention subtrees are not exactly there.

The **training forward** (``apply_unet(train=True)``, and any forward that
returns the deep-supervision heads or keeps the norms of an unfolded
BatchNorm model) follows the reference's ``_block_apply``: conv, then
channel-wise dropout in ``cfg.dropout_levels``, then the norm (BatchNorm in
batch-statistics mode with the running-stat update, or eval BatchNorm with
the running statistics; GroupNorm / InstanceNorm from
:func:`_spatial_group_stats`), then LeakyReLU.  Its band convs take the
differentiable ``conv3d_tap_merged`` (no slope: the norm sits between the
conv and the activation); its other convs ``F.conv3d``; and whenever
autograd records, its up-convs ``F.conv_transpose3d`` (``upconv2x`` has no
gradient).  GroupNorm forwards that record gradients never take the
deferred ``conv_stage`` path.

**Sharded forwards** (``braintpu_torch.parallel``): inside
:func:`sharded_forward`, the forward consults a :class:`Sharding`.

* ``spatial``: this rank holds one slab of the X axis (dim 1).  Every
  stride-1 3x3x3 conv takes its neighbours' boundary planes (zero padding
  stays only at the global edges) and keeps its own output planes; the
  stride-2 pooling convs take the left neighbour's last plane; the
  GroupNorm / InstanceNorm statistics (``conv_stage``'s, restricted to the
  rank's own output planes, and :func:`_spatial_group_stats`) are summed over
  the shards and divided by the global voxel count.  The dispatch reads the
  global shape, so a sharded layer takes the kernel its unsharded layer
  takes.  Up-convs and the seg head need no halo.
* ``data``: the batch is split; BatchNorm's training statistics are taken
  over the global batch (two-pass, summed over the ranks; their gradient
  too).
* ``model``: the blocks and up-convs whose weights are in ``split`` hold
  only their share of the output channels (column parallelism): the input's
  gradient is summed over the ranks, the norm runs on the local channels,
  and the outputs are gathered along channels.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv3d import conv3d_tap_merged, kernel_supported
from .axial import apply_axial_attention, apply_axial_block, init_axial_block, init_axial_params
from ..ops.stage import conv_stage, stage_supported
from ..ops.upconv import upconv2x, upconv2x_ref, upconv_supported

__all__ = [
    "UNetConfig",
    "MODEL1_BN",
    "MODEL2_GN_LARGE",
    "AXIAL_UNET",
    "AXIAL_UNET_FULL",
    "attention_plan",
    "encoder_features",
    "bottleneck_features",
    "decoder_channels",
    "forward_flops",
    "conv_layers",
    "deferred_layers",
    "upconv_layers",
    "init_params",
    "fold_batchnorm",
    "param_count",
    "estimate_activation_bytes",
    "choose_impl",
    "choose_stage_impl",
    "resolve_conv_impl",
    "conv_routes",
    "apply_unet",
    "Sharding",
    "sharded_forward",
]


@dataclass(frozen=True)
class UNetConfig:
    """Static architecture description (fields as in the reference config)."""

    in_channels: int = 4
    num_classes: int = 3
    base_features: int = 32
    max_features: int = 320
    num_pool: int = 5
    conv_per_stage: int = 2
    encoder_scale: int = 1
    norm: str = "batch"  # "batch" | "group" | "instance"
    group_norm_groups: int = 8
    norm_eps: float = 1e-5
    #: BatchNorm running-stat momentum of the training forward
    bn_momentum: float = 0.1
    negative_slope: float = 0.01
    #: sliding-window patch (``infer.sliding_window``); fullconv ignores it
    patch_size: Tuple[int, int, int] = (128, 128, 128)
    pool_kernel: Tuple[int, int, int] = (2, 2, 2)
    conv_kernel: Tuple[int, int, int] = (3, 3, 3)
    compute_dtype: torch.dtype = torch.bfloat16
    #: the dtype :func:`init_params` draws its leaves at
    param_dtype: torch.dtype = torch.float32
    #: the conv lowering (:func:`resolve_conv_impl`): "auto", the measured
    #: per-layer dispatch (:func:`choose_impl`, :func:`choose_stage_impl`);
    #: "pallas", the Hopper tap kernel for every conv it takes; "xla3d",
    #: "decomp2d", "merged2d", the library's ``F.conv3d`` for every conv
    conv_impl: str = "auto"
    #: encoder stages whose convs take channel-wise dropout in training
    dropout_levels: Tuple[int, ...] = (4,)
    dropout_rate: float = 0.0
    #: the head's nonlinearity as named by the reference's config ("sigmoid"
    #: for the regions models, "softmax" for classic heads); carried, read
    #: by no forward (the engines apply the sigmoid of the regions recipe)
    final_nonlin: str = "sigmoid"
    #: Axial attention (the reference's Axial_UNet extras).  "decoder": the
    #: Generic_UNet option, sequential per-axis attention residually after
    #: each up-conv, ``no_attention_levels`` indexed by decoder stage u
    #: (0 = deepest), heads and dim_head scaled by 2**d.  "full": the
    #: Axial_UNet family, AxialAttention3D blocks (positional embedding,
    #: summed per-axis attention, BatchNorm, LeakyReLU) after every encoder
    #: stage and every decoder up-conv, ``no_attention_levels`` indexed by
    #: resolution level d (0 = finest), heads and dim_head scaled by 2**d.
    axial_attention: bool = False
    attn_heads: int = 8
    attn_dim_head: int = 32
    no_attention_levels: Tuple[int, ...] = (0,)
    axial_mode: str = "decoder"
    axial_bn: bool = True
    axial_sum_out: bool = True
    axial_residual: bool = False

    @property
    def name(self) -> str:
        return (
            f"unet3d_{self.norm}_s{self.encoder_scale}"
            f"_f{self.base_features}x{self.num_pool}"
        )


#: KAIST model 1: nnUNetTrainerV2BraTSRegions_DA4_BN_BD.
MODEL1_BN = UNetConfig(norm="batch", encoder_scale=1)
#: KAIST model 2: ..._largeUnet_Groupnorm (GroupNorm, double-width encoder).
MODEL2_GN_LARGE = UNetConfig(norm="group", encoder_scale=2)
#: Axial-attention decoder variant (Generic_UNet ``axial_attention=True``).
AXIAL_UNET = UNetConfig(norm="batch", encoder_scale=1, axial_attention=True)
#: Full Axial_UNet family: encoder and decoder AxialAttention3D blocks
#: (the reference's defaults heads=2, dim_heads=8).
AXIAL_UNET_FULL = UNetConfig(norm="batch", encoder_scale=1, axial_attention=True,
                             axial_mode="full", attn_heads=2, attn_dim_head=8)


def encoder_features(cfg: UNetConfig) -> List[int]:
    """Per-stage encoder output channels (before the bottleneck)."""
    feats = []
    f = cfg.base_features * cfg.encoder_scale
    for _ in range(cfg.num_pool):
        feats.append(min(f, cfg.max_features))
        f = int(round(f * 2))
    return feats


def bottleneck_features(cfg: UNetConfig) -> int:
    return min(encoder_features(cfg)[-1] * 2, cfg.max_features)


def decoder_channels(cfg: UNetConfig) -> List[Dict[str, int]]:
    """Channel plan for each decoder stage (deepest first)."""
    enc = encoder_features(cfg)
    plan = []
    from_down = bottleneck_features(cfg)
    for u in range(cfg.num_pool):
        skip = enc[cfg.num_pool - 1 - u]
        out = max(1, int(skip // cfg.encoder_scale))
        plan.append({"from_down": from_down, "skip": skip, "out": out})
        from_down = out
    return plan


def forward_flops(cfg: UNetConfig, spatial_shape: Tuple[int, int, int]) -> int:
    """Analytic FLOPs of ONE eval-mode forward at ``spatial_shape``:
    2 x out_voxels x k^3 x ci x co per conv, the up-convs and the final seg
    head (the same count as the reference's ``forward_flops``)."""
    k3 = int(np.prod(cfg.conv_kernel))
    shrink = int(np.prod(cfg.pool_kernel))
    vox_full = int(np.prod(spatial_shape))
    bneck = bottleneck_features(cfg)
    flops = 0
    cin = cfg.in_channels
    for d, f in enumerate(encoder_features(cfg)):
        vox = vox_full // (shrink**d)
        for c in range(cfg.conv_per_stage):
            flops += 2 * vox * k3 * (cin if c == 0 else f) * f
        cin = f
    vox = vox_full // (shrink**cfg.num_pool)
    for c in range(cfg.conv_per_stage):
        flops += 2 * vox * k3 * (cin if c == 0 else bneck) * bneck
        cin = bneck
    for u, ch in enumerate(decoder_channels(cfg)):
        vox = vox_full // (shrink ** (cfg.num_pool - 1 - u))
        flops += 2 * vox * ch["from_down"] * ch["skip"]
        # nnU-Net decoder floor-of-2: concat conv, conv_per_stage-2 more, out conv
        n_extra = max(cfg.conv_per_stage - 2, 0)
        chans = [(2 * ch["skip"], ch["skip"])] + [(ch["skip"], ch["skip"])] * n_extra
        chans.append((ch["skip"], ch["out"]))
        for ci, co in chans:
            flops += 2 * vox * k3 * ci * co
    flops += 2 * vox_full * decoder_channels(cfg)[-1]["out"] * cfg.num_classes
    return int(flops)


def conv_layers(
    cfg: UNetConfig, spatial_shape: Tuple[int, int, int], batch: int = 1
) -> List[Tuple[Tuple[int, ...], Tuple[int, int, int], int]]:
    """``(input shape NDHWC, stride, co)`` of every 3x3x3 conv of one forward
    at ``spatial_shape``, in execution order (what :func:`choose_impl` sees)."""
    pool = tuple(cfg.pool_kernel)
    dims = tuple(int(s) for s in spatial_shape)
    down = lambda d: tuple(s // p for s, p in zip(d, pool))
    layers = []
    cin = cfg.in_channels
    for d, f in enumerate(encoder_features(cfg)):
        for c in range(cfg.conv_per_stage):
            stride = pool if (d > 0 and c == 0) else (1, 1, 1)
            layers.append(((batch, *dims, cin if c == 0 else f), stride, f))
            if stride != (1, 1, 1):
                dims = down(dims)
        cin = f
    bneck = bottleneck_features(cfg)
    for c in range(cfg.conv_per_stage):
        layers.append(((batch, *dims, cin), pool if c == 0 else (1, 1, 1), bneck))
        if c == 0:
            dims = down(dims)
        cin = bneck
    for ch in decoder_channels(cfg):
        dims = tuple(s * p for s, p in zip(dims, pool))
        n_extra = max(cfg.conv_per_stage - 2, 0)
        chans = [(2 * ch["skip"], ch["skip"])] + [(ch["skip"], ch["skip"])] * n_extra
        chans.append((ch["skip"], ch["out"]))
        for ci, co in chans:
            layers.append(((batch, *dims, ci), (1, 1, 1), co))
    return layers


def deferred_layers(
    cfg: UNetConfig, spatial_shape: Tuple[int, int, int], batch: int = 1
) -> List[Tuple[Tuple[int, ...], Tuple[int, int, int], int, int]]:
    """:func:`conv_layers` as the deferred-norm path calls them:
    ``(first input shape NDHWC, stride, co, ci2)``, where the first conv of
    each decoder stage reads the up-conv output (``ci1 = skip``) and the
    skip (``ci2 = skip``) as two inputs, and every other conv has
    ``ci2 = 0`` (what :func:`choose_stage_impl` sees)."""
    n_enc = (cfg.num_pool + 1) * cfg.conv_per_stage
    per_stage = max(cfg.conv_per_stage - 2, 0) + 2
    out = []
    for i, (shape, stride, co) in enumerate(conv_layers(cfg, spatial_shape, batch)):
        if i >= n_enc and (i - n_enc) % per_stage == 0:
            ci2 = shape[4] // 2
            out.append(((*shape[:4], shape[4] - ci2), stride, co, ci2))
        else:
            out.append((shape, stride, co, 0))
    return out


def upconv_layers(
    cfg: UNetConfig, spatial_shape: Tuple[int, int, int], batch: int = 1
) -> List[Tuple[Tuple[int, ...], int]]:
    """``(input shape NDHWC, co)`` of every 2x2x2 up-conv of one forward, in
    execution order (deepest first)."""
    deepest = tuple(int(s) // p ** cfg.num_pool for s, p in zip(spatial_shape, cfg.pool_kernel))
    out = []
    for u, ch in enumerate(decoder_channels(cfg)):
        dims = tuple(s * p**u for s, p in zip(deepest, cfg.pool_kernel))
        out.append(((batch, *dims, ch["from_down"]), ch["skip"]))
    return out


# ---------------------------------------------------------------------------
# Initialization (the reference's numpy draws, in the reference's order)
# ---------------------------------------------------------------------------


def _he_init(rng: np.random.Generator, shape, negative_slope: float) -> torch.Tensor:
    """Kaiming-normal fan-in with leaky-ReLU gain (torch ``kaiming_normal_``),
    f32, drawn with numpy as the reference draws it.  The callers cast it to
    ``param_dtype`` (the reference's ``astype``: one round to nearest even)."""
    fan_in = int(np.prod(shape[:-1]))  # (kd, kh, kw, cin) for DHWIO
    gain = np.sqrt(2.0 / (1.0 + negative_slope**2))
    std = gain / np.sqrt(fan_in)
    vals = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return torch.from_numpy(vals.astype(np.float32))


def _init_block(rng: np.random.Generator, cin: int, cout: int, cfg: UNetConfig):
    dt = cfg.param_dtype
    block = {
        "w": _he_init(rng, (*cfg.conv_kernel, cin, cout), cfg.negative_slope).to(dt),
        "b": torch.zeros(cout, dtype=dt),
        "scale": torch.ones(cout, dtype=dt),
        "shift": torch.zeros(cout, dtype=dt),
    }
    if cfg.norm == "batch":
        block["mean"] = torch.zeros(cout, dtype=dt)
        block["var"] = torch.ones(cout, dtype=dt)
    return block


def attention_plan(cfg: UNetConfig) -> Dict[str, Dict[int, Dict[str, Any]]]:
    """Where an axial config's attention sits: ``{"encoder": {d: spec},
    "decoder": {u: spec}}`` (empty for a plain U-Net).  A spec is ``{"kind":
    "attn_block" | "attn", "channels", "shape" (the feature map's D, H, W at
    ``cfg.patch_size``), "heads" (at initialisation), "dim_head"}``.

    "full": a block after encoder level d and after the up-conv of decoder
    stage u (level ``d = num_pool - u - 1``), unless d is in
    ``no_attention_levels``; heads and dim_head scaled by ``2**d``.
    "decoder": a residual attention after the up-conv of stage u unless u is
    in ``no_attention_levels``, heads and dim_head scaled by ``2**d`` and the
    heads halved until ``heads * dim_head <= 2 * skip`` (the reference's cap
    at initialisation; a converted checkpoint keeps its own head count).
    """
    plan: Dict[str, Dict[int, Dict[str, Any]]] = {"encoder": {}, "decoder": {}}
    if not cfg.axial_attention:
        return plan
    P = cfg.num_pool
    full = cfg.axial_mode == "full"

    def spec(kind, channels, d, heads):
        return {"kind": kind, "channels": channels,
                "shape": tuple(int(s // (2**d)) for s in cfg.patch_size),
                "heads": heads, "dim_head": cfg.attn_dim_head * (2**d)}

    if full:
        for d, f in enumerate(encoder_features(cfg)):
            if d not in cfg.no_attention_levels:
                plan["encoder"][d] = spec("attn_block", f, d, cfg.attn_heads * (2**d))
    for u, ch in enumerate(decoder_channels(cfg)):
        d = P - u - 1
        if full and d not in cfg.no_attention_levels:
            plan["decoder"][u] = spec("attn_block", ch["skip"], d, cfg.attn_heads * (2**d))
        elif not full and u not in cfg.no_attention_levels:
            heads = cfg.attn_heads * (2**d)
            while heads * cfg.attn_dim_head * (2**d) > 2 * ch["skip"] and heads > 1:
                heads //= 2
            plan["decoder"][u] = spec("attn", ch["skip"], d, heads)
    return plan


def init_params(cfg: UNetConfig, seed: int) -> Dict[str, Any]:
    """Random parameters at ``cfg.param_dtype`` from an int seed.

    The conv leaves are the reference's ``init_params(cfg, seed)`` bit for
    bit, at any ``param_dtype`` (a numpy Generator of the seed, drawn in f32
    in the same order and cast).  An axial
    config's attention leaves (:func:`attention_plan`) come from a second
    numpy Generator of ``(seed, 1)``, in the reference's order (encoder
    levels, then decoder stages); the reference draws them from
    its own random keys, so their values differ from its.
    """
    rng = np.random.default_rng(int(seed))
    attn_rng = np.random.default_rng((int(seed), 1))
    plan = attention_plan(cfg)

    def attention(s):
        if s["kind"] == "attn_block":
            return init_axial_block(attn_rng, s["channels"], s["shape"], s["heads"],
                                    s["dim_head"], bn=cfg.axial_bn, param_dtype=cfg.param_dtype)
        return init_axial_params(attn_rng, s["channels"], s["shape"], s["heads"], s["dim_head"],
                                 cfg.param_dtype)

    enc = encoder_features(cfg)
    bneck = bottleneck_features(cfg)
    encoder = []
    cin = cfg.in_channels
    for f in enc:
        encoder.append([_init_block(rng, cin if c == 0 else f, f, cfg)
                        for c in range(cfg.conv_per_stage)])
        cin = f
    encoder_attn = {str(d): attention(s) for d, s in plan["encoder"].items()}
    bottleneck = []
    for _ in range(cfg.conv_per_stage):
        bottleneck.append(_init_block(rng, cin, bneck, cfg))
        cin = bneck
    decoder = []
    for u, ch in enumerate(decoder_channels(cfg)):
        up_w = _he_init(rng, (ch["from_down"], *cfg.pool_kernel, ch["skip"]),
                        cfg.negative_slope).to(cfg.param_dtype)
        # StackedConvLayers always builds its first block: two decoder convs
        # at least, whatever conv_per_stage (the reference's floor of 2)
        blocks = [_init_block(rng, 2 * ch["skip"], ch["skip"], cfg)]
        for _ in range(max(cfg.conv_per_stage - 2, 0)):
            blocks.append(_init_block(rng, ch["skip"], ch["skip"], cfg))
        blocks.append(_init_block(rng, ch["skip"], ch["out"], cfg))
        seg_w = _he_init(rng, (1, 1, 1, ch["out"], cfg.num_classes),
                         cfg.negative_slope).to(cfg.param_dtype)
        stage = {"up": {"w": up_w}, "blocks": blocks, "seg": {"w": seg_w}}
        if u in plan["decoder"]:
            stage[plan["decoder"][u]["kind"]] = attention(plan["decoder"][u])
        decoder.append(stage)
    out = {"encoder": encoder, "bottleneck": bottleneck, "decoder": decoder}
    if encoder_attn:
        out["encoder_attn"] = encoder_attn
    return out


def fold_batchnorm(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """Fold eval-mode BatchNorm into conv weights/biases, in f32.

    ``w' = w * k`` and ``b' = (b - mean) * k + shift`` with
    ``k = scale / sqrt(var + eps)``.  Leaves are upcast to f32 first, so
    f16-stored checkpoints fold at full precision.  Every subtree that is
    not a conv block (an axial model's ``encoder_attn``, a decoder stage's
    ``attn`` / ``attn_block``) is kept as it is, its BatchNorm included: the
    attention blocks normalise in the forward.
    """
    if cfg.norm != "batch":
        raise ValueError("fold_batchnorm requires a BatchNorm model")

    def fold_block(block):
        blk = {k: v.float() for k, v in block.items()}
        k = blk["scale"] / torch.sqrt(blk["var"] + cfg.norm_eps)
        return {"w": blk["w"] * k, "b": (blk["b"] - blk["mean"]) * k + blk["shift"]}

    return {
        **{k: v for k, v in params.items() if k not in ("encoder", "bottleneck", "decoder")},
        "encoder": [[fold_block(b) for b in stage] for stage in params["encoder"]],
        "bottleneck": [fold_block(b) for b in params["bottleneck"]],
        "decoder": [
            {
                **{k: v for k, v in stage.items() if k not in ("up", "blocks", "seg")},
                "up": {"w": stage["up"]["w"].float()},
                "blocks": [fold_block(b) for b in stage["blocks"]],
                "seg": {"w": stage["seg"]["w"].float()},
            }
            for stage in params["decoder"]
        ],
    }


def param_count(params) -> int:
    """Number of parameters: the sizes of every array leaf (tensor or numpy)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return int(np.prod(params.shape))


def estimate_activation_bytes(cfg: UNetConfig, batch: int = 1) -> int:
    """Rough peak activation footprint of one forward at ``cfg.patch_size``
    (bytes), the reference's estimator: the encoder and decoder feature maps
    summed at ``compute_dtype``'s width, each level shrunk by the product of
    the pool kernel."""
    itemsize = cfg.compute_dtype.itemsize
    vox = int(np.prod(cfg.patch_size))
    shrink = int(np.prod(cfg.pool_kernel))
    total = 0
    for d, f in enumerate(encoder_features(cfg)):
        total += (vox // (shrink**d)) * f * cfg.conv_per_stage
    total += (vox // (shrink**cfg.num_pool)) * bottleneck_features(cfg) * cfg.conv_per_stage
    for u, ch in enumerate(decoder_channels(cfg)):
        scale = shrink ** (cfg.num_pool - 1 - u)
        total += (vox // scale) * (2 * ch["skip"] + ch["out"])
    return total * batch * itemsize


def choose_impl(
    shape: Tuple[int, ...],
    kernel: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    co: int,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> str:
    """``"kernel"`` (hand-written Hopper conv) or ``"library"`` (F.conv3d).

    The reference's ``_choose_impl`` sends a conv to its Pallas kernel when
    it is a stride-1 3x3x3 conv with ``48 <= D < 96`` and ``co >= 64`` that
    the kernel takes, and its ``_conv3d_pallas`` keeps the kernel to bf16
    compute.  The same band goes to the Hopper kernel here.  The reference
    also drops a layer whose working set would not fit the TPU core's VMEM
    (``plan_tiles``); the Hopper kernel has no such limit and the port does
    not carry that gate.  It admits every MODEL1_BN layer of the band at the
    128x128x96 and 224x224x128 buckets; it rejects level 1 of a
    160x192x160 bucket, which the port sends to the kernel (pinned by a
    test).
    """
    if tuple(kernel) != (3, 3, 3) or tuple(stride) != (1, 1, 1):
        return "library"
    if compute_dtype != torch.bfloat16:
        return "library"
    D = shape[1]
    if 48 <= D < 96 and co >= 64 and kernel_supported(tuple(shape), co):
        return "kernel"
    return "library"


def choose_stage_impl(
    shape: Tuple[int, ...],
    kernel: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    co: int,
    ci2: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> str:
    """``"kernel"`` (hand-written Hopper ``conv_stage``) or ``"library"``
    (materialize, ``F.conv3d``, statistics) for one deferred-norm conv.

    ``shape`` is the first input's (N, D, H, W, ci1), ``ci2`` the skip's
    channels.  The reference's ``_fused_block`` takes the stage kernel for
    every stride-1 3x3x3 conv that ``conv_stage_supported`` admits, and
    ``_fused_supported`` keeps the path to bf16.  Its VMEM planner
    (``plan_stage_tiles``) also rejects layers whose band does not fit a TPU
    core, among them every H that is not a multiple of 8; the Hopper kernel
    has no such limit and the port does not carry that gate (pinned by a
    test).
    """
    if tuple(kernel) != (3, 3, 3) or tuple(stride) != (1, 1, 1):
        return "library"
    if compute_dtype != torch.bfloat16:
        return "library"
    return "kernel" if stage_supported(tuple(shape), co, ci2) else "library"


#: the reference's ``conv_impl`` values; every one but "auto" and "pallas"
#: names a TPU lowering of XLA's, which the library's ``F.conv3d`` takes
#: the place of
_CONV_IMPLS = ("auto", "decomp2d", "merged2d", "pallas", "xla3d")


def resolve_conv_impl(
    cfg: UNetConfig,
    shape: Tuple[int, ...],
    kernel: Tuple[int, int, int],
    stride: Tuple[int, int, int],
    co: int,
    ci2: Optional[int] = None,
) -> str:
    """Where one conv goes under ``cfg.conv_impl``: ``"kernel"`` (the Hopper
    tap kernel), ``"stage"`` (the Hopper ``conv_stage``) or ``"library"``
    (``F.conv3d``).  Every conv of every forward is dispatched here.

    ``shape`` is the conv's (N, D, H, W, ci) input (the global shape of an
    X-sharded conv).  A deferred-norm conv (a GroupNorm / InstanceNorm eval
    forward) passes ``ci2``, the skip's channels (0 without a skip), and
    ``shape`` holds the first input's channels only.

    * "auto": :func:`choose_impl` (the band to the tap kernel) and, for a
      deferred-norm conv, :func:`choose_stage_impl` (``conv_stage``);
    * "pallas": the tap kernel for every stride-1 3x3x3 conv of a bf16
      config that it takes (``kernel_supported``), whatever its depth, the
      rest to the library, as the reference's ``_conv3d_pallas`` falls
      back; never ``conv_stage`` (the reference's fused stage path needs
      "auto"): a deferred-norm conv materializes its inputs first;
    * "xla3d", "decomp2d", "merged2d": the library;
    * anything else raises the reference's ``ValueError``.
    """
    impl = cfg.conv_impl
    if impl == "auto":
        if ci2 is None:
            return choose_impl(shape, kernel, stride, co, cfg.compute_dtype)
        stage = choose_stage_impl(shape, kernel, stride, co, ci2, cfg.compute_dtype)
        return "stage" if stage == "kernel" else "library"
    if impl == "pallas":
        full = tuple(shape) if not ci2 else (*shape[:4], shape[4] + ci2)
        if (tuple(kernel) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
                and cfg.compute_dtype == torch.bfloat16 and kernel_supported(full, co)):
            return "kernel"
        return "library"
    if impl in _CONV_IMPLS:
        return "library"
    raise ValueError(
        f"unknown conv_impl {impl!r}: expected 'auto', 'decomp2d', "
        "'merged2d', 'pallas' or 'xla3d'")


def conv_routes(cfg: UNetConfig, spatial_shape: Tuple[int, int, int],
                batch: int = 1) -> List[str]:
    """:func:`resolve_conv_impl` of every 3x3x3 conv of one eval forward at
    ``spatial_shape``, in execution order: the deferred-norm layers
    (:func:`deferred_layers`) for a GroupNorm / InstanceNorm U-Net, else
    :func:`conv_layers`."""
    if cfg.norm != "batch" and not cfg.axial_attention:
        return [resolve_conv_impl(cfg, s, cfg.conv_kernel, st, co, c2)
                for s, st, co, c2 in deferred_layers(cfg, spatial_shape, batch)]
    return [resolve_conv_impl(cfg, s, cfg.conv_kernel, st, co)
            for s, st, co in conv_layers(cfg, spatial_shape, batch)]


@dataclass(frozen=True)
class Sharding:
    """How one forward is spread over ranks; each field a
    :class:`braintpu_torch.parallel.collectives.Comm` or None."""

    spatial: Any = None  # X slabs (inference)
    data: Any = None  # batch rows (BatchNorm training statistics)
    model: Any = None  # column-parallel blocks
    split: FrozenSet[int] = frozenset()  # ids of the weight tensors split over ``model``


_SHARDING: contextvars.ContextVar = contextvars.ContextVar("braintpu_torch_sharding",
                                                           default=None)


@contextlib.contextmanager
def sharded_forward(sharding: Sharding):
    """Run the forwards inside the block under ``sharding``."""
    token = _SHARDING.set(sharding)
    try:
        yield sharding
    finally:
        _SHARDING.reset(token)


def _axis(name: str):
    """The Comm of a sharded axis of the current forward, or None."""
    sh = _SHARDING.get()
    comm = None if sh is None else getattr(sh, name)
    return comm if (comm is not None and comm.spread) else None


def _split_comm(w: torch.Tensor):
    """The model axis when ``w`` is a column-parallel weight, else None."""
    sh = _SHARDING.get()
    comm = _axis("model")
    return comm if (comm is not None and id(w) in sh.split) else None


def _halo_extend(x: torch.Tensor, comm) -> Tuple[torch.Tensor, int]:
    """``x`` (N, L, H, W, C) with its neighbours' boundary planes along X
    (none at the global edges); returns it and the offset of ``x`` in it."""
    from ..parallel.collectives import halo_exchange

    left, right = halo_exchange(x, comm, dim=1)
    parts = [p for p in (left, x, right) if p is not None]
    return torch.cat(parts, dim=1), (0 if left is None else 1)


def _global_shape(x: torch.Tensor, comm) -> Tuple[int, ...]:
    return (int(x.shape[0]), int(x.shape[1]) * comm.size, *(int(s) for s in x.shape[2:]))


def _low_precision_on_cpu(x: torch.Tensor, dtype: torch.dtype) -> bool:
    return x.device.type == "cpu" and dtype != torch.float32


def _conv3d_library(x, w, b, stride, dtype, negative_slope: Optional[float], pad=None):
    """``F.conv3d`` on NDHWC/DHWIO tensors (channels-last views, no copies of x).

    On the CPU a bf16 config computes in f32 from the operands rounded to
    bf16 and rounds the result, as the card's bf16 conv (f32 accumulation)
    does.  ``pad`` defaults to SAME (``(k - 1) // 2`` per axis).
    """
    if pad is None:
        pad = tuple((k - 1) // 2 for k in w.shape[:3])
    if _low_precision_on_cpu(x, dtype):
        y = F.conv3d(x.to(dtype).float().permute(0, 4, 1, 2, 3),
                     w.to(dtype).float().permute(4, 3, 0, 1, 2), b.to(dtype).float(), stride, pad)
    else:
        wt = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), wt, b.to(dtype), stride, pad)
    if negative_slope is not None:
        y = F.leaky_relu(y, negative_slope)
    return y.to(dtype).permute(0, 2, 3, 4, 1)


def _block(x, block, cfg: UNetConfig, stride) -> torch.Tensor:
    """Folded-BN block: Conv + bias -> LeakyReLU (fused in the kernel).

    The kernel is used at the compute dtype whatever its stored dtype, as
    the reference casts at the point of use.  A block that still carries
    BatchNorm statistics was never folded: it raises rather than run with
    the norm dropped.
    """
    if "mean" in block or "var" in block:
        raise ValueError("BatchNorm block with running statistics: fold it first "
                         "(fold_batchnorm), or call apply_unet with folded=False")
    return _conv(x, block, stride, cfg, cfg.negative_slope)


def _conv(x, block, stride, cfg: UNetConfig, negative_slope: Optional[float]) -> torch.Tensor:
    """One 3-D conv + bias (+ LeakyReLU) at the compute dtype, dispatched by
    :func:`resolve_conv_impl`: to the Hopper kernel (differentiable) or to
    ``F.conv3d``.  X-sharded (:class:`Sharding`), the dispatch reads the
    global shape."""
    w = block["w"]
    comm = _axis("spatial")
    shape = tuple(x.shape) if comm is None else _global_shape(x, comm)
    impl = resolve_conv_impl(cfg, shape, tuple(w.shape[:3]), stride, int(w.shape[4]))
    return _conv_on(x, w, block["b"], stride, cfg.compute_dtype, negative_slope, impl == "kernel")


def _conv_on(x, w, b, stride, dtype, negative_slope: Optional[float], kernel: bool):
    """The conv on the tap kernel (``kernel``) or ``F.conv3d``; X-sharded
    (:class:`Sharding`), it reads its neighbours' boundary planes."""
    comm = _axis("spatial")
    if comm is not None:
        return _conv_spatial(x, w, b, stride, dtype, negative_slope, comm, kernel)
    if kernel:
        return conv3d_tap_merged(x.to(dtype).contiguous(), w.to(dtype).contiguous(), b.float(),
                                 negative_slope)
    return _conv3d_library(x, w, b, stride, dtype, negative_slope)


def _conv_spatial(x, w, b, stride, dtype, negative_slope, comm, kernel: bool) -> torch.Tensor:
    """One conv of an X slab.  Stride 1 (3x3x3): the slab with its
    neighbours' boundary planes, the conv with SAME padding, the slab's own
    output planes.  The stride-2 pooling conv (3x3x3, pad 1): output plane
    ``o`` reads input planes ``2o - 1 .. 2o + 1``, so the slab (of even
    length, starting at an even plane) takes its left neighbour's last plane
    (zeros at the global edge) and the conv pads X by 0."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"X-sharded conv of kernel {tuple(w.shape[:3])}: only 3x3x3 is sharded")
    L = int(x.shape[1])
    if tuple(stride) == (1, 1, 1):
        ext, lo = _halo_extend(x, comm)
        if kernel:
            y = conv3d_tap_merged(ext.to(dtype).contiguous(), w.to(dtype).contiguous(), b.float(),
                                  negative_slope)
        else:
            y = _conv3d_library(ext, w, b, stride, dtype, negative_slope)
        return y[:, lo:lo + L].contiguous()
    if tuple(stride) != (2, 2, 2) or L % 2:
        raise ValueError(f"X-sharded conv of stride {tuple(stride)} on a slab of {L} planes: "
                         "only stride 2 on even slabs is sharded")
    from ..parallel.collectives import halo_exchange

    left, _ = halo_exchange(x, comm, dim=1, right=False)
    if left is None:
        left = torch.zeros_like(x[:, :1])
    return _conv3d_library(torch.cat([left, x], dim=1), w, b, stride, dtype, negative_slope,
                           pad=(0, 1, 1))


def _records(*tensors) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _upconv_library(x, w, dtype) -> torch.Tensor:
    """``F.conv_transpose3d`` on NDHWC / (Ci, 2, 2, 2, Co) tensors at ``dtype``
    (differentiable).  On the CPU a bf16 config computes in f32 from the
    rounded operands and rounds the result, as the card's bf16 path does."""
    wt = w.to(dtype).permute(0, 4, 1, 2, 3)
    xt = x.to(dtype).permute(0, 4, 1, 2, 3)
    if _low_precision_on_cpu(x, dtype):
        y = F.conv_transpose3d(xt.float(), wt.float(), stride=tuple(w.shape[1:4]))
    else:
        y = F.conv_transpose3d(xt, wt.contiguous(), stride=tuple(w.shape[1:4]))
    return y.to(dtype).permute(0, 2, 3, 4, 1)


def _upconv(x, w, dtype) -> torch.Tensor:
    """2x2x2 stride-2 transposed conv (``w``: (Ci, 2, 2, 2, Co)), no bias.

    A bf16 config sends it to the Hopper kernel ``upconv2x`` (the GEMM with
    the pixel shuffle in its epilogue; on CPU tensors its plain version);
    anything else takes the plain version at ``dtype``.  When autograd
    records, it takes ``F.conv_transpose3d`` (the kernel has no gradient),
    as the reference's training forward takes XLA's.
    """
    if _records(x, w):
        return _upconv_library(x, w, dtype)
    if (tuple(w.shape[1:4]) == (2, 2, 2) and dtype == torch.bfloat16
            and upconv_supported(tuple(x.shape), int(w.shape[4]))):
        return upconv2x(x.to(dtype).contiguous(), w.to(dtype).contiguous())
    return upconv2x_ref(x, w, dtype)


def _seg_head(x, seg_w, dtype) -> torch.Tensor:
    """1x1x1 seg head without bias: ``x`` and ``seg_w`` rounded to the
    compute dtype, accumulated in f32 (f32 logits), as in the reference."""
    return x.to(dtype).float() @ seg_w[0, 0, 0].to(dtype).float()


# ---------------------------------------------------------------------------
# Deferred-norm path (GroupNorm / InstanceNorm inference)
# ---------------------------------------------------------------------------
#
# A state is ``(raw, aff)``: the conv output before normalization and the
# per-channel affine ``aff = (a, c, slope)`` (or None) meaning
# ``final = leaky_slope(raw * a + c)``.  ``a`` and ``c`` are (N, C): the
# statistics are per sample, as in the reference.


def _materialize(h, aff, dtype) -> torch.Tensor:
    """Apply a deferred affine + LeakyReLU in f32 and round to ``dtype``."""
    if aff is None:
        return h
    a, c, slope = aff
    if a.dim() == 2:  # per-sample (N, C)
        a = a[:, None, None, None, :]
        c = c[:, None, None, None, :]
    t = h.float() * a + c
    return torch.where(t >= 0, t, t * slope).to(dtype)


def _spatial_group_stats(x: torch.Tensor, g: int):
    """Per-(sample, group) spatial mean and variance of ``x`` in f32 (the
    reference's ``"sum"`` form: E[x^2] - E[x]^2 over f32 sums).  X-sharded,
    the sums are added over the shards and divided by the global count.

    Returns ``(mean, var)``, each (N, g).
    """
    N, D, H, W, C = x.shape
    xm = x.reshape(N, D * H * W, C).float()
    s1 = xm.sum(dim=1)
    s2 = (xm * xm).sum(dim=1)
    return _moments(*_shard_sums(s1, s2, D * H * W), g)


def _shard_sums(s1: torch.Tensor, s2: torch.Tensor, nvox: int):
    """Per-sample sums of a slab -> the whole volume's, and its voxel count
    (unchanged outside an X-sharded forward)."""
    comm = _axis("spatial")
    if comm is None:
        return s1, s2, nvox
    from ..parallel.collectives import all_reduce_stat

    s = all_reduce_stat(torch.stack([s1, s2]), comm)
    return s[0], s[1], nvox * comm.size


def _moments(s1: torch.Tensor, s2: torch.Tensor, nvox: int, g: int):
    """Group mean / variance from per-channel (N, C) sums over ``nvox`` voxels."""
    N, C = s1.shape
    n = nvox * (C // g)
    mean = s1.reshape(N, g, C // g).sum(dim=2) / n
    var = torch.clamp(s2.reshape(N, g, C // g).sum(dim=2) / n - mean * mean, min=0.0)
    return mean, var


def _affine_from_moments(mean_g, var_g, block, cfg: UNetConfig, co: int):
    """Fold group/instance moments and the learned scale/shift into
    ``(a, c, slope)`` with (N, co) ``a`` and ``c``."""
    rep = co // mean_g.shape[-1]
    mean_c = torch.repeat_interleave(mean_g, rep, dim=-1)
    rstd_c = torch.repeat_interleave(torch.rsqrt(var_g + cfg.norm_eps), rep, dim=-1)
    a = rstd_c * block["scale"].float()
    c = block["shift"].float() - mean_c * a
    return a, c, cfg.negative_slope


def _deferred_block(state, skip_state, block, stride, cfg: UNetConfig):
    """One Conv -> Norm -> LeakyReLU block in deferred-norm form: returns the
    new ``(raw, aff)`` state (the counterpart of the reference's
    ``_fused_block`` for an unfolded norm)."""
    h, aff = state
    w, b = block["w"], block["b"]
    co, ci = int(w.shape[4]), int(w.shape[3])
    N, D, H, W, ci1 = h.shape
    g = cfg.group_norm_groups if cfg.norm == "group" else co
    comm = _axis("spatial")
    shape = tuple(h.shape) if comm is None else _global_shape(h, comm)
    impl = resolve_conv_impl(cfg, shape, tuple(w.shape[:3]), stride, co, ci - ci1)
    if impl == "stage":
        # X-sharded: each input with its neighbours' planes (raw: the kernel
        # applies the affine as it reads them), the slab's own output planes
        # only, their statistics then summed over the shards
        x1, lo = (h, 0) if comm is None else _halo_extend(h, comm)
        kw = {}
        if aff is not None:
            kw.update(a1=aff[0], c1=aff[1], in1_slope=aff[2])
        if skip_state is not None:
            h2, aff2 = skip_state
            x2 = h2 if comm is None else _halo_extend(h2, comm)[0]
            kw["x2"] = x2.to(cfg.compute_dtype).contiguous()
            if aff2 is not None:
                kw.update(a2=aff2[0], c2=aff2[1], in2_slope=aff2[2])
        if comm is not None:
            kw["out_planes"] = (lo, lo + D)
        y, s1, s2 = conv_stage(x1.to(cfg.compute_dtype).contiguous(),
                               w.to(torch.bfloat16).contiguous(), b.float(), stats=True, **kw)
        mean_g, var_g = _moments(*_shard_sums(s1, s2, D * H * W), g)
        return y, _affine_from_moments(mean_g, var_g, block, cfg, co)
    # the reference's fallback: materialize the input(s), the conv (the tap
    # kernel under conv_impl="pallas" where it takes the layer, else the
    # library), and the statistics of the rounded output
    hm = _materialize(h, aff, cfg.compute_dtype)
    if skip_state is not None:
        hm = torch.cat([hm, _materialize(*skip_state, cfg.compute_dtype)], dim=-1)
    y = _conv_on(hm, w, b, stride, cfg.compute_dtype, None, impl == "kernel")
    mean_g, var_g = _spatial_group_stats(y, g)
    return y, _affine_from_moments(mean_g, var_g, block, cfg, co)


def _apply_unet_deferred(params, x, cfg: UNetConfig) -> torch.Tensor:
    """Eval-mode forward of a GroupNorm / InstanceNorm U-Net with deferred
    norms (the reference's ``_apply_unet_fused`` for an unfolded model)."""
    stride1 = (1, 1, 1)
    pool = tuple(cfg.pool_kernel)
    dtype = cfg.compute_dtype
    state = (x.to(dtype), None)
    skips = []
    for d, stage in enumerate(params["encoder"]):
        for c, block in enumerate(stage):
            state = _deferred_block(state, None, block, pool if (d > 0 and c == 0) else stride1, cfg)
        skips.append(state)
    for c, block in enumerate(params["bottleneck"]):
        state = _deferred_block(state, None, block, pool if c == 0 else stride1, cfg)
    for u, stage in enumerate(params["decoder"]):
        state = (_upconv(_materialize(*state, dtype), stage["up"]["w"], dtype), None)
        skip = skips[-(u + 1)]
        for i, block in enumerate(stage["blocks"]):
            state = _deferred_block(state, skip if i == 0 else None, block, stride1, cfg)
    return _seg_head(_materialize(*state, dtype), params["decoder"][-1]["seg"]["w"], dtype)


# ---------------------------------------------------------------------------
# Norm-in-the-forward path (training, deep supervision, unfolded BatchNorm)
# ---------------------------------------------------------------------------


def _norm(y: torch.Tensor, block, cfg: UNetConfig, train: bool, split: int = 1):
    """Normalize a conv output with f32 statistics and arithmetic (the
    reference's ``_norm``).  Returns ``(f32 tensor, new_stats or None)``.

    BatchNorm in training: ``F.batch_norm`` on the f32 upcast, batch
    statistics with the biased variance, and the running update
    ``(1 - m) * old + m * batch`` with the unbiased variance, on copies of the
    block's statistics (returned as ``new_stats``); with the batch split over
    ranks (:class:`Sharding` ``data``), the global batch's statistics
    (:func:`_batch_moments`).  BatchNorm at eval: the running statistics.
    GroupNorm / InstanceNorm: per-sample statistics of the upcast from
    :func:`_spatial_group_stats`, under autograd.  ``split``: the block's
    output channels are split that many ways (column parallelism), so this
    rank holds ``groups / split`` of the groups.
    """
    x = y.float()
    scale, shift = block["scale"].float(), block["shift"].float()
    eps = cfg.norm_eps
    if cfg.norm == "batch":
        if train:
            mean = block["mean"].detach().float().clone()
            var = block["var"].detach().float().clone()
            comm = _axis("data")
            if comm is not None:
                return _batch_norm_global(x, mean, var, scale, shift, cfg, comm)
            out = F.batch_norm(x.permute(0, 4, 1, 2, 3), mean, var, scale, shift, True,
                               cfg.bn_momentum, eps)
            return out.permute(0, 2, 3, 4, 1), {"mean": mean, "var": var}
        mean, var = block["mean"].float(), block["var"].float()
        return (x - mean) * torch.rsqrt(var + eps) * scale + shift, None
    if cfg.norm not in ("group", "instance"):
        raise ValueError(f"unknown norm {cfg.norm!r}")
    N, C = x.shape[0], x.shape[-1]
    g = cfg.group_norm_groups // split if cfg.norm == "group" else C
    mean_g, var_g = _spatial_group_stats(x, g)  # (N, g) each
    mean = torch.repeat_interleave(mean_g, C // g, dim=1).reshape(N, 1, 1, 1, C)
    var = torch.repeat_interleave(var_g, C // g, dim=1).reshape(N, 1, 1, 1, C)
    # (x - mean) * (rsqrt * scale): one full-size product kept for autograd
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + shift, None


def _batch_norm_global(x, run_mean, run_var, scale, shift, cfg: UNetConfig, comm):
    """Training BatchNorm over a batch split across ranks: the global
    batch's per-channel mean, then its biased variance (two passes, each
    summed over the ranks with its gradient), and the running update with
    the unbiased variance, as ``F.batch_norm`` over the whole batch."""
    from ..parallel.collectives import all_reduce_stat

    n = x[..., 0].numel() * comm.size
    mean = all_reduce_stat(x.sum(dim=(0, 1, 2, 3)), comm) / n
    xc = x - mean
    var = all_reduce_stat((xc * xc).sum(dim=(0, 1, 2, 3)), comm) / n
    m = cfg.bn_momentum
    with torch.no_grad():
        run_mean.mul_(1 - m).add_(m * mean.detach())
        run_var.mul_(1 - m).add_(m * var.detach() * (n / max(n - 1, 1)))
    out = xc * torch.rsqrt(var + cfg.norm_eps) * scale + shift
    return out, {"mean": run_mean, "var": run_var}


def _dropout(y: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Channel-wise dropout (``nn.Dropout3d``): one keep draw per (sample,
    channel) from ``generator``, kept channels scaled by 1/keep."""
    keep = 1.0 - rate
    N, C = y.shape[0], y.shape[-1]
    mask = torch.rand((N, 1, 1, 1, C), generator=generator, device=y.device) < keep
    return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype, device=y.device)).to(y.dtype)


def _block_apply(x, block, cfg: UNetConfig, stride, train: bool, folded: bool,
                 generator: Optional[torch.Generator] = None):
    """Conv -> (Dropout) -> Norm -> LeakyReLU, the reference's ``_block_apply``.
    Returns ``(y at the compute dtype, new_stats)``; a folded BatchNorm block
    is Conv + LeakyReLU (:func:`_block`)."""
    if folded and cfg.norm == "batch":
        return _block(x, block, cfg, stride), None
    tp = _split_comm(block["w"])  # column parallel: this rank's output channels
    if tp is not None:
        from ..parallel.collectives import copy_to_axis

        x = copy_to_axis(x, tp)
    y = _conv(x, block, stride, cfg, None)
    if generator is not None:
        y = _dropout(y, cfg.dropout_rate, generator)
    t, new_stats = _norm(y, block, cfg, train, split=1 if tp is None else tp.size)
    # where(t >= 0) as the reference (its gradient at 0 is 1); keeps a bool mask only
    t = torch.where(t >= 0, t, t * cfg.negative_slope).to(cfg.compute_dtype)
    if tp is not None:
        from ..parallel.collectives import gather_channels

        t = gather_channels(t, tp)
    return t, new_stats


def _apply_unet_blocks(params, x, cfg: UNetConfig, train: bool, heads: bool, folded: bool,
                       generator: Optional[torch.Generator]):
    """The reference's non-fused ``apply_unet`` body, axial branches
    included: returns the final head's logits, or ``(heads full-resolution
    first, new_stats)``.  With ``folded`` (a folded BatchNorm model) every
    block is Conv + LeakyReLU: the band on the tap kernel with the slope
    fused, and the up-convs on ``upconv2x`` unless autograd records."""
    stride1 = (1, 1, 1)
    pool = tuple(cfg.pool_kernel)
    dtype = cfg.compute_dtype
    new_stats: Dict[str, Any] = {"encoder": [], "bottleneck": [], "decoder": []}
    drop = generator if (train and cfg.dropout_rate > 0) else None

    def attn_block(block, h, d: int, key: str, idx: int):
        # the block's BatchNorm takes its default eps (1e-5), as the reference's
        out = apply_axial_block(block, h, cfg.attn_dim_head * (2**d), cfg.negative_slope,
                                cfg.axial_sum_out, cfg.axial_residual, train=train,
                                bn_momentum=cfg.bn_momentum)
        if train:
            out, st = out
            new_stats.setdefault(key, {})[str(idx)] = st
        return out.to(dtype)

    skips = []
    h = x
    for d, stage in enumerate(params["encoder"]):
        stage_stats = []
        gen = drop if d in cfg.dropout_levels else None
        for c, block in enumerate(stage):
            h, st = _block_apply(h, block, cfg, pool if (d > 0 and c == 0) else stride1, train,
                                 folded, gen)
            stage_stats.append(st)
        if str(d) in params.get("encoder_attn", {}):
            h = attn_block(params["encoder_attn"][str(d)], h, d, "encoder_attn", d)
        new_stats["encoder"].append(stage_stats)
        skips.append(h)
    for c, block in enumerate(params["bottleneck"]):
        h, st = _block_apply(h, block, cfg, pool if c == 0 else stride1, train, folded)
        new_stats["bottleneck"].append(st)
    seg_logits = []
    last = len(params["decoder"]) - 1
    for u, stage in enumerate(params["decoder"]):
        tp = _split_comm(stage["up"]["w"])
        if tp is None:
            h = _upconv(h, stage["up"]["w"], dtype)
        else:  # column parallel, as a split block
            from ..parallel.collectives import copy_to_axis, gather_channels

            h = gather_channels(_upconv(copy_to_axis(h, tp), stage["up"]["w"], dtype), tp)
        dlev = cfg.num_pool - u - 1
        if "attn_block" in stage:
            h = attn_block(stage["attn_block"], h, dlev, "decoder_attn", u)
        elif "attn" in stage:
            # dim_head scaled by 2**d as the reference's AxialAttention
            # (dim_heads * 2**d), so converted checkpoints split heads as trained
            h = (apply_axial_attention(stage["attn"], h, cfg.attn_dim_head * (2**dlev)) + h
                 ).to(dtype)
        h = torch.cat([h, skips[-(u + 1)]], dim=-1)
        stage_stats = []
        for block in stage["blocks"]:
            h, st = _block_apply(h, block, cfg, stride1, train, folded)
            stage_stats.append(st)
        new_stats["decoder"].append(stage_stats)
        if heads or u == last:
            seg_logits.append(_seg_head(h, stage["seg"]["w"], dtype))
    if heads:
        return [seg_logits[-1]] + seg_logits[:-1][::-1], new_stats
    return seg_logits[-1]


def _check_attention(params, cfg: UNetConfig) -> None:
    """Raise unless the tree's attention subtrees are exactly where
    :func:`attention_plan` puts them: an axial tree that lost one would
    otherwise run as a plain U-Net and still give plausible labels."""
    plan = attention_plan(cfg)
    enc = set(params.get("encoder_attn", {}))
    want_enc = {str(d) for d in plan["encoder"]}
    if enc != want_enc:
        raise ValueError(f"encoder_attn levels {sorted(enc)} != {sorted(want_enc)} for "
                         f"{cfg.name} (axial_attention={cfg.axial_attention}, "
                         f"axial_mode={cfg.axial_mode!r})")
    blocks = [(f"encoder_attn/{d}", params["encoder_attn"][d]) for d in sorted(enc)]
    for u, stage in enumerate(params["decoder"]):
        have = {k for k in ("attn", "attn_block") if k in stage}
        want = {plan["decoder"][u]["kind"]} if u in plan["decoder"] else set()
        if have != want:
            raise ValueError(f"decoder/{u}: attention subtrees {sorted(have)} != {sorted(want)} "
                             f"for {cfg.name} (axial_attention={cfg.axial_attention}, "
                             f"axial_mode={cfg.axial_mode!r})")
        if "attn_block" in stage:
            blocks.append((f"decoder/{u}/attn_block", stage["attn_block"]))
    for where, block in blocks:
        want = {"attn", "bn"} if cfg.axial_bn else {"attn"}
        if set(block) != want:
            raise ValueError(f"{where}: attention block keys {sorted(block)} != {sorted(want)} "
                             f"(axial_bn={cfg.axial_bn})")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def apply_unet(
    params: Dict[str, Any],
    x: torch.Tensor,
    cfg: UNetConfig,
    train: bool = False,
    deep_supervision: bool = False,
    generator: Optional[torch.Generator] = None,
    folded: bool = False,
):
    """Forward pass.

    Args:
      params: :func:`init_params`-layout parameters (conv kernels at any
        float dtype: they are used at ``cfg.compute_dtype``), or for a
        BatchNorm model :func:`fold_batchnorm` output with ``folded=True``.
      x: (N, D, H, W, C) input, every spatial axis a multiple of
        ``2**num_pool``.
      train: BatchNorm in batch-statistics mode (with the running-stat
        update) and dropout active (where ``generator`` is given and
        ``cfg.dropout_rate > 0``).
      deep_supervision: return every decoder head, full resolution first.
      generator: the ``torch.Generator`` dropout draws from (on ``x``'s
        device); it takes the place of the reference's ``rng`` key.
      folded: a BatchNorm model's norms are folded into the convs (False by
        default, as in the reference: the norms then run in the forward,
        with the running statistics unless ``train``).  A block that still
        carries running statistics raises under ``folded=True``.  GroupNorm
        and InstanceNorm models have nothing to fold and ignore it.

    Returns:
      eval mode: (N, D, H, W, num_classes) f32 logits of the final head.
      ``train`` or ``deep_supervision``: ``(heads, new_stats)``, the heads'
      f32 logits full resolution first and ``new_stats`` mirroring the
      parameter tree with the updated BatchNorm running statistics
      (``None`` per block outside BatchNorm training).
    """
    if cfg.norm not in ("batch", "group", "instance"):
        raise ValueError(f"unknown norm {cfg.norm!r}")
    _check_attention(params, cfg)
    heads = train or deep_supervision
    if (not heads and cfg.norm != "batch" and not cfg.axial_attention
            and not _records(x, *_leaves(params))):
        return _apply_unet_deferred(params, x, cfg)
    return _apply_unet_blocks(params, x, cfg, train, heads, folded, generator)
