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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv3d import conv3d_tap_merged, kernel_supported
from ..ops.stage import conv_stage, stage_supported
from ..ops.upconv import upconv2x, upconv2x_ref, upconv_supported

__all__ = [
    "UNetConfig",
    "MODEL1_BN",
    "MODEL2_GN_LARGE",
    "encoder_features",
    "bottleneck_features",
    "decoder_channels",
    "forward_flops",
    "conv_layers",
    "deferred_layers",
    "upconv_layers",
    "init_params",
    "fold_batchnorm",
    "choose_impl",
    "choose_stage_impl",
    "apply_unet",
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
    negative_slope: float = 0.01
    pool_kernel: Tuple[int, int, int] = (2, 2, 2)
    conv_kernel: Tuple[int, int, int] = (3, 3, 3)
    compute_dtype: torch.dtype = torch.bfloat16

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
    f32, drawn with numpy as the reference draws it."""
    fan_in = int(np.prod(shape[:-1]))  # (kd, kh, kw, cin) for DHWIO
    gain = np.sqrt(2.0 / (1.0 + negative_slope**2))
    std = gain / np.sqrt(fan_in)
    vals = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return torch.from_numpy(vals.astype(np.float32))


def _init_block(rng: np.random.Generator, cin: int, cout: int, cfg: UNetConfig):
    block = {
        "w": _he_init(rng, (*cfg.conv_kernel, cin, cout), cfg.negative_slope),
        "b": torch.zeros(cout),
        "scale": torch.ones(cout),
        "shift": torch.zeros(cout),
    }
    if cfg.norm == "batch":
        block["mean"] = torch.zeros(cout)
        block["var"] = torch.ones(cout)
    return block


def init_params(cfg: UNetConfig, seed: int) -> Dict[str, Any]:
    """Random f32 parameters from an int seed: the same leaves, bit for bit,
    as the reference's ``init_params(cfg, seed)`` (a numpy Generator of the
    seed, drawn in the same order)."""
    rng = np.random.default_rng(int(seed))
    enc = encoder_features(cfg)
    bneck = bottleneck_features(cfg)
    encoder = []
    cin = cfg.in_channels
    for f in enc:
        encoder.append([_init_block(rng, cin if c == 0 else f, f, cfg)
                        for c in range(cfg.conv_per_stage)])
        cin = f
    bottleneck = []
    for _ in range(cfg.conv_per_stage):
        bottleneck.append(_init_block(rng, cin, bneck, cfg))
        cin = bneck
    decoder = []
    for ch in decoder_channels(cfg):
        up_w = _he_init(rng, (ch["from_down"], *cfg.pool_kernel, ch["skip"]), cfg.negative_slope)
        # StackedConvLayers always builds its first block: two decoder convs
        # at least, whatever conv_per_stage (the reference's floor of 2)
        blocks = [_init_block(rng, 2 * ch["skip"], ch["skip"], cfg)]
        for _ in range(max(cfg.conv_per_stage - 2, 0)):
            blocks.append(_init_block(rng, ch["skip"], ch["skip"], cfg))
        blocks.append(_init_block(rng, ch["skip"], ch["out"], cfg))
        seg_w = _he_init(rng, (1, 1, 1, ch["out"], cfg.num_classes), cfg.negative_slope)
        decoder.append({"up": {"w": up_w}, "blocks": blocks, "seg": {"w": seg_w}})
    return {"encoder": encoder, "bottleneck": bottleneck, "decoder": decoder}


def fold_batchnorm(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """Fold eval-mode BatchNorm into conv weights/biases, in f32.

    ``w' = w * k`` and ``b' = (b - mean) * k + shift`` with
    ``k = scale / sqrt(var + eps)``.  Leaves are upcast to f32 first, so
    f16-stored checkpoints fold at full precision.
    """
    if cfg.norm != "batch":
        raise ValueError("fold_batchnorm requires a BatchNorm model")

    def fold_block(block):
        blk = {k: v.float() for k, v in block.items()}
        k = blk["scale"] / torch.sqrt(blk["var"] + cfg.norm_eps)
        return {"w": blk["w"] * k, "b": (blk["b"] - blk["mean"]) * k + blk["shift"]}

    return {
        "encoder": [[fold_block(b) for b in stage] for stage in params["encoder"]],
        "bottleneck": [fold_block(b) for b in params["bottleneck"]],
        "decoder": [
            {
                "up": {"w": stage["up"]["w"].float()},
                "blocks": [fold_block(b) for b in stage["blocks"]],
                "seg": {"w": stage["seg"]["w"].float()},
            }
            for stage in params["decoder"]
        ],
    }


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


def _low_precision_on_cpu(x: torch.Tensor, dtype: torch.dtype) -> bool:
    return x.device.type == "cpu" and dtype != torch.float32


def _conv3d_library(x, w, b, stride, dtype, negative_slope: Optional[float]):
    """``F.conv3d`` on NDHWC/DHWIO tensors (channels-last views, no copies of x).

    On the CPU a bf16 config computes in f32 from the bf16 operands and
    rounds the result, as the card's bf16 conv (f32 accumulation) does.
    """
    pad = tuple((k - 1) // 2 for k in w.shape[:3])
    if _low_precision_on_cpu(x, dtype):
        y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                     b.float(), stride, pad)
    else:
        wt = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), wt, b.to(dtype), stride, pad)
    if negative_slope is not None:
        y = F.leaky_relu(y, negative_slope)
    return y.to(dtype).permute(0, 2, 3, 4, 1)


def _block(x, block, cfg: UNetConfig, stride) -> torch.Tensor:
    """Folded-BN block: Conv + bias -> LeakyReLU (fused in the kernel)."""
    w, b = block["w"], block["b"]
    impl = choose_impl(tuple(x.shape), tuple(w.shape[:3]), stride, int(w.shape[4]),
                       cfg.compute_dtype)
    if impl == "kernel":
        return conv3d_tap_merged(x.contiguous(), w, b, cfg.negative_slope)
    return _conv3d_library(x, w, b, stride, cfg.compute_dtype, cfg.negative_slope)


def _upconv(x, w, dtype) -> torch.Tensor:
    """2x2x2 stride-2 transposed conv (``w``: (Ci, 2, 2, 2, Co)), no bias.

    A bf16 config sends it to the Hopper kernel ``upconv2x`` (the GEMM with
    the pixel shuffle in its epilogue; on CPU tensors its plain version);
    anything else takes the plain version at ``dtype``.
    """
    if (tuple(w.shape[1:4]) == (2, 2, 2) and dtype == torch.bfloat16
            and upconv_supported(tuple(x.shape), int(w.shape[4]))):
        return upconv2x(x.to(dtype).contiguous(), w.to(dtype).contiguous())
    return upconv2x_ref(x, w, dtype)


def _seg_head(x, seg_w) -> torch.Tensor:
    """1x1x1 seg head without bias, f32 logits."""
    return x.float() @ seg_w[0, 0, 0].float()


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
    reference's ``"sum"`` form: E[x^2] - E[x]^2 over f32 sums).

    Returns ``(mean, var)``, each (N, g).
    """
    N, D, H, W, C = x.shape
    xm = x.reshape(N, D * H * W, C).float()
    s1 = xm.sum(dim=1)
    s2 = (xm * xm).sum(dim=1)
    return _moments(s1, s2, D * H * W, g)


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
    impl = choose_stage_impl(tuple(h.shape), tuple(w.shape[:3]), stride, co, ci - ci1,
                             cfg.compute_dtype)
    if impl == "kernel":
        kw = {}
        if aff is not None:
            kw.update(a1=aff[0], c1=aff[1], in1_slope=aff[2])
        if skip_state is not None:
            h2, aff2 = skip_state
            kw["x2"] = h2.to(cfg.compute_dtype).contiguous()
            if aff2 is not None:
                kw.update(a2=aff2[0], c2=aff2[1], in2_slope=aff2[2])
        y, s1, s2 = conv_stage(h.to(cfg.compute_dtype).contiguous(),
                               w.to(torch.bfloat16).contiguous(), b.float(), stats=True, **kw)
        mean_g, var_g = _moments(s1, s2, D * H * W, g)
        return y, _affine_from_moments(mean_g, var_g, block, cfg, co)
    # the reference's fallback: materialize the input(s), library conv, and
    # the statistics of the rounded output
    hm = _materialize(h, aff, cfg.compute_dtype)
    if skip_state is not None:
        hm = torch.cat([hm, _materialize(*skip_state, cfg.compute_dtype)], dim=-1)
    y = _conv3d_library(hm, w, b, stride, cfg.compute_dtype, None)
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
    return _seg_head(_materialize(*state, dtype), params["decoder"][-1]["seg"]["w"])


def apply_unet(
    params: Dict[str, Any], x: torch.Tensor, cfg: UNetConfig, folded: bool = True
) -> torch.Tensor:
    """Eval-mode forward.

    Args:
      params: for a BatchNorm model, :func:`fold_batchnorm` output; for a
        GroupNorm / InstanceNorm model, the unfolded parameters (conv kernels
        at any float dtype: they are used at ``cfg.compute_dtype``).
      x: (N, D, H, W, C) input, every spatial axis a multiple of
        ``2**num_pool``.
      folded: whether a BatchNorm model's norms are folded; it must be True
        (an unfolded BatchNorm forward is not ported).  GroupNorm and
        InstanceNorm models have nothing to fold and ignore it.

    Returns:
      (N, D, H, W, num_classes) f32 logits of the full-resolution head.
    """
    if cfg.norm in ("group", "instance"):
        return _apply_unet_deferred(params, x, cfg)
    if cfg.norm != "batch":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    if not folded:
        raise NotImplementedError("unfolded BatchNorm is not ported (see fold_batchnorm)")
    stride1 = (1, 1, 1)
    pool = tuple(cfg.pool_kernel)
    h = x.to(cfg.compute_dtype)
    skips = []
    for d, stage in enumerate(params["encoder"]):
        for c, block in enumerate(stage):
            h = _block(h, block, cfg, pool if (d > 0 and c == 0) else stride1)
        skips.append(h)
    for c, block in enumerate(params["bottleneck"]):
        h = _block(h, block, cfg, pool if c == 0 else stride1)
    for u, stage in enumerate(params["decoder"]):
        h = _upconv(h, stage["up"]["w"], cfg.compute_dtype)
        h = torch.cat([h, skips[-(u + 1)]], dim=-1)
        for block in stage["blocks"]:
            h = _block(h, block, cfg, stride1)
    return _seg_head(h, params["decoder"][-1]["seg"]["w"])
