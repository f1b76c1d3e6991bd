"""3D U-Net (nnU-Net KAIST BraTS-2021 topology) in PyTorch.

Counterpart of ``braintpu/models/unet3d.py``.  Parameters are the same
nested dicts (``encoder`` / ``bottleneck`` / ``decoder``) with the same
layouts -- channels-last activations (NDHWC), DHWIO conv kernels,
``(Ci,2,2,2,Co)`` up-convs -- so the tests hand both packages the same
arrays.  :func:`apply_unet` is a plain function over such a dict.

This slice covers the inference forward of BatchNorm models with the norm
folded into the convs (:func:`fold_batchnorm`): Conv -> LeakyReLU blocks,
stride-2 pooling convs, 2x2x2 up-convs with the pixel-shuffle result, and the
final 1x1x1 seg head.  GroupNorm / InstanceNorm models (MODEL2_GN_LARGE) are
the next slice and raise ``NotImplementedError``.

Conv dispatch (:func:`choose_impl`) sends the layers the reference sends to
its Pallas kernel -- stride-1 3x3x3 convs with ``48 <= D < 96`` and
``co >= 64`` in a bf16 compute config -- to the hand-written Hopper kernel
``ops.conv3d.conv3d_tap_merged`` (bias and LeakyReLU fused), and every other
conv to ``torch.nn.functional.conv3d`` (what the reference leaves to XLA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv3d import conv3d_tap_merged, kernel_supported

__all__ = [
    "UNetConfig",
    "MODEL1_BN",
    "MODEL2_GN_LARGE",
    "encoder_features",
    "bottleneck_features",
    "decoder_channels",
    "forward_flops",
    "conv_layers",
    "fold_batchnorm",
    "choose_impl",
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
#: KAIST model 2: ..._largeUnet_Groupnorm (config only: its forward is the next slice).
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
    """2x2x2 stride-2 transposed conv as one GEMM (Ci -> 8 Co) + pixel shuffle.

    ``w``: (Ci, kd, kh, kw, Co).  Non-overlapping windows make this exact.
    """
    ci, kd, kh, kw, co = w.shape
    N, D, H, W, _ = x.shape
    if _low_precision_on_cpu(x, dtype):
        y = x.reshape(-1, ci).float() @ w.reshape(ci, -1).float()
    else:
        y = x.to(dtype).reshape(-1, ci) @ w.to(dtype).reshape(ci, -1)
    y = y.to(dtype).view(N, D, H, W, kd, kh, kw, co)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(N, D * kd, H * kh, W * kw, co)


def _seg_head(x, seg_w) -> torch.Tensor:
    """1x1x1 seg head without bias, f32 logits."""
    return x.float() @ seg_w[0, 0, 0].float()


def apply_unet(
    params: Dict[str, Any], x: torch.Tensor, cfg: UNetConfig, folded: bool = True
) -> torch.Tensor:
    """Eval-mode forward of a folded-BN U-Net.

    Args:
      params: :func:`fold_batchnorm` output (conv kernels at any float dtype;
        they are used at ``cfg.compute_dtype``).
      x: (N, D, H, W, C) input, every spatial axis a multiple of
        ``2**num_pool``.
      folded: must be True: unfolded norms are the next slice.

    Returns:
      (N, D, H, W, num_classes) f32 logits of the full-resolution head.
    """
    if cfg.norm != "batch":
        raise NotImplementedError(f"norm={cfg.norm!r}: GroupNorm/InstanceNorm models are the next slice")
    if not folded:
        raise NotImplementedError("only folded-BN parameters are ported (see fold_batchnorm)")
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
