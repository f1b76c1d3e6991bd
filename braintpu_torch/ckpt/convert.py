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
``ckpt.npz.save_pytree_npz`` writes as a fold.

The axial families map too.  ``axial_mode="full"`` (Axial_UNet):
``axial_attention_down.{j}`` / ``axial_attention_up.{j}``, each an
``axial_attention`` sequential of positional embedding (0), attention (1)
and BatchNorm (2), onto ``encoder_attn[d]`` and the decoder stages'
``attn_block``; ``axial_mode="decoder"`` (Generic_UNet):
``axial_embedding.{j}`` + ``axial_attention.{j}`` onto the decoder stages'
``attn``.  ``j`` counts the attending levels in build order (the as-built
sequential indexing of the reference's converter).  The ``axial_attention``
package's layout: ``<emb>.param_{0,1,2}`` are (1, C, D, 1, 1) / (1, C, 1,
H, 1) / (1, C, 1, 1, W) additive embeddings; ``<attn>.axial_attentions.{i}
.fn.to_q`` / ``to_kv`` / ``to_out`` the per-axis Linears in D, H, W order,
``to_q`` and ``to_kv`` fused into one (C, 3 inner) projection here and
``to_out``'s bias kept as ``out_b``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np

from ..models.unet3d import UNetConfig, decoder_channels, encoder_features
from .npz import flatten_pytree, load_pytree_npz, save_pytree_npz, unflatten_pytree

__all__ = ["convert_state_dict", "convert_torch_checkpoint", "flatten_pytree", "load_pytree_npz",
           "load_torch_checkpoint", "save_pytree_npz", "unflatten_pytree"]


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


def _axial_params_from(sd: Mapping[str, Any], emb_prefix: str, attn_prefix: str) -> Dict[str, Any]:
    """AxialPositionalEmbedding + AxialAttention state -> axial parameters."""
    pos = {}
    for i, name in enumerate("dhw"):
        p = _np(sd[f"{emb_prefix}.param_{i}"])
        pos[name] = p.reshape(p.shape[1], -1).T  # (1, C, ..axis..) -> (axis, C)
    axes = []
    for i in range(3):
        base = f"{attn_prefix}.axial_attentions.{i}.fn"
        q = _np(sd[f"{base}.to_q.weight"])  # (inner, C), torch Linear layout
        kv = _np(sd[f"{base}.to_kv.weight"])  # (2 inner, C), k then v
        ax = {"qkv": np.concatenate([q.T, kv.T], axis=1),  # (C, 3 inner): q | k | v
              "out": _np(sd[f"{base}.to_out.weight"]).T}  # (inner, C)
        if f"{base}.to_out.bias" in sd:
            ax["out_b"] = _np(sd[f"{base}.to_out.bias"])
        axes.append(ax)
    return {"pos": pos, "axes": axes}


def _axial_bn_from(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "shift": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}


def _axial_block_from(sd: Mapping[str, Any], base: str) -> Dict[str, Any]:
    """One AxialAttention3D sequential (embedding, attention, BatchNorm if saved)."""
    blk: Dict[str, Any] = {"attn": _axial_params_from(sd, f"{base}.0", f"{base}.1")}
    if f"{base}.2.running_mean" in sd:
        blk["bn"] = _axial_bn_from(sd, f"{base}.2")
    return blk


def convert_state_dict(sd: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """Map a ``Generic_UNet`` / ``Axial_UNet`` state_dict onto the parameter
    tree (f32 numpy leaves), checked against ``cfg``'s channel plan.

    Raises ``ValueError`` for a shape that does not match ``cfg``;
    ``KeyError`` for a missing tensor.
    """
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v for k, v in sd.items()}
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
    if cfg.axial_attention and cfg.axial_mode == "full":
        att_levels = [d for d in range(P) if d not in cfg.no_attention_levels]
        encoder_attn = {str(d): _axial_block_from(sd, f"axial_attention_down.{j}.axial_attention")
                        for j, d in enumerate(att_levels)}
        if encoder_attn:
            params["encoder_attn"] = encoder_attn
        up = [u for u in range(P) if (P - u - 1) not in cfg.no_attention_levels]
        for k, u in enumerate(up):
            decoder[u]["attn_block"] = _axial_block_from(
                sd, f"axial_attention_up.{k}.axial_attention")
    elif cfg.axial_attention:
        up = [u for u in range(P) if u not in cfg.no_attention_levels]
        for j, u in enumerate(up):
            decoder[u]["attn"] = _axial_params_from(sd, f"axial_embedding.{j}",
                                                    f"axial_attention.{j}")
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
