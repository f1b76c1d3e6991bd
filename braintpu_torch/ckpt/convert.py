"""Checkpoint conversion: PyTorch nnU-Net ``.model`` files -> reference-layout trees.

Copy of ``braintpu/ckpt/convert.py``'s conversion half.  The reference
loads 10 torch checkpoints (2 models x 5 folds,
``fold_{0..4}/model_final_checkpoint.model``); this module maps their
``state_dict`` naming onto the U-Net parameter tree (NDHWC / DHWIO layout):

==============================================  =============================
torch name                                       tree path
==============================================  =============================
conv_blocks_context.{d}.blocks.{c}.conv.*        encoder[d][c].w/.b
conv_blocks_context.{P}.{0|1}.blocks.{c}.conv.*  bottleneck[c'].w/.b
conv_blocks_context...instnorm.*                 ...scale/shift(/mean/var)
tu.{u}.weight                                    decoder[u].up.w
conv_blocks_localization.{u}.{0|1}.blocks...     decoder[u].blocks[c']
seg_outputs.{u}.weight                           decoder[u].seg.w
==============================================  =============================

Weight transposes: Conv3d ``(O, I, kd, kh, kw) -> (kd, kh, kw, I, O)``;
ConvTranspose3d ``(I, O, kd, kh, kw) -> (I, kd, kh, kw, O)``; seg 1x1x1
``(O, I, 1, 1, 1) -> (1, 1, 1, I, O)``.

The result is a tree of f32 numpy arrays, the reference's own output, which
``ckpt.npz.params_from_jax`` turns into the port's parameters and
``ckpt.npz.save_pytree_npz`` writes as a fold.  The axial-attention
families (``axial_embedding`` / ``axial_attention`` / ``axial_attention_up``
/ ``axial_attention_down`` keys) are not ported yet (ROADMAP A4): such a
state dict raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np

from ..models.unet3d import UNetConfig, decoder_channels, encoder_features

__all__ = ["convert_state_dict", "convert_torch_checkpoint", "load_torch_checkpoint"]


def _np(x) -> np.ndarray:
    """torch.Tensor | ndarray -> float32 ndarray."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _conv_block_from(sd: Mapping[str, Any], prefix: str, has_bn_stats: bool) -> Dict[str, np.ndarray]:
    block = {
        "w": _np(sd[f"{prefix}.conv.weight"]).transpose(2, 3, 4, 1, 0),
        "b": _np(sd[f"{prefix}.conv.bias"]),
        "scale": _np(sd[f"{prefix}.instnorm.weight"]),
        "shift": _np(sd[f"{prefix}.instnorm.bias"]),
    }
    if has_bn_stats:
        block["mean"] = _np(sd[f"{prefix}.instnorm.running_mean"])
        block["var"] = _np(sd[f"{prefix}.instnorm.running_var"])
    return block


def convert_state_dict(sd: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """Map a ``Generic_UNet`` state_dict onto the parameter tree (f32 numpy
    leaves), checked against ``cfg``'s channel plan.

    Raises ``ValueError`` for an axial-attention state dict (not ported) or
    a shape that does not match ``cfg``; ``KeyError`` for a missing tensor.
    """
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v for k, v in sd.items()}
    axial = sorted({k.split(".", 1)[0] for k in sd if k.startswith("axial_")})
    if axial:
        raise ValueError(f"axial-attention checkpoint ({', '.join(axial)}): the axial "
                         "families are not ported yet (ROADMAP A4)")
    has_bn = cfg.norm == "batch"
    P = cfg.num_pool

    encoder: List[List[dict]] = []
    for d in range(P):
        encoder.append([
            _conv_block_from(sd, f"conv_blocks_context.{d}.blocks.{c}", has_bn)
            for c in range(cfg.conv_per_stage)
        ])

    # bottleneck = Sequential(Stacked(conv_per_stage-1), Stacked(1))
    bottleneck: List[dict] = []
    for c in range(cfg.conv_per_stage - 1):
        bottleneck.append(_conv_block_from(sd, f"conv_blocks_context.{P}.0.blocks.{c}", has_bn))
    bottleneck.append(_conv_block_from(sd, f"conv_blocks_context.{P}.1.blocks.0", has_bn))

    decoder: List[dict] = []
    for u in range(P):
        up_w = _np(sd[f"tu.{u}.weight"]).transpose(0, 2, 3, 4, 1)
        blocks = [
            _conv_block_from(sd, f"conv_blocks_localization.{u}.0.blocks.{c}", has_bn)
            for c in range(cfg.conv_per_stage - 1)
        ]
        blocks.append(_conv_block_from(sd, f"conv_blocks_localization.{u}.1.blocks.0", has_bn))
        seg_w = _np(sd[f"seg_outputs.{u}.weight"]).transpose(2, 3, 4, 1, 0)
        decoder.append({"up": {"w": up_w}, "blocks": blocks, "seg": {"w": seg_w}})

    params = {"encoder": encoder, "bottleneck": bottleneck, "decoder": decoder}
    _validate_shapes(params, cfg)
    return params


def _validate_shapes(params: Dict[str, Any], cfg: UNetConfig) -> None:
    enc = encoder_features(cfg)
    for d, stage in enumerate(params["encoder"]):
        for c, blk in enumerate(stage):
            cin = (cfg.in_channels if d == 0 else enc[d - 1]) if c == 0 else enc[d]
            expect = (*cfg.conv_kernel, cin, enc[d])
            if blk["w"].shape != expect:
                raise ValueError(
                    f"encoder[{d}][{c}].w shape {blk['w'].shape} != {expect} "
                    f"(checkpoint does not match config {cfg.name})"
                )
    for u, ch in enumerate(decoder_channels(cfg)):
        got = params["decoder"][u]["up"]["w"].shape
        expect = (ch["from_down"], *cfg.pool_kernel, ch["skip"])
        if got != expect:
            raise ValueError(f"decoder[{u}].up.w shape {got} != {expect}")


def load_torch_checkpoint(path: os.PathLike) -> Dict[str, Any]:
    """Load an nnU-Net ``.model`` file's state_dict.

    ``weights_only=False`` as in the reference: nnU-Net's checkpoints pickle
    more than tensors (optimizer state, plans), so load only files you trust.
    """
    import torch

    ckpt = torch.load(os.fspath(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def convert_torch_checkpoint(path: os.PathLike, cfg: UNetConfig) -> Dict[str, Any]:
    return convert_state_dict(load_torch_checkpoint(path), cfg)
