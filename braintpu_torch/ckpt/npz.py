"""Read the reference package's ``.npz`` checkpoints and carry the weights across.

:func:`load_pytree_npz` is a copy of ``braintpu/ckpt/convert.py::load_pytree_npz``:
it reads the flat ``a/b/c``-keyed npz (``results/trained_synth/checkpoints/
model{1,2}/fold_N.npz``) into nested dicts and lists of numpy arrays.

:func:`params_from_jax` turns such a tree (DHWIO conv kernels,
``(Ci,2,2,2,Co)`` up-convs, ``(1,1,1,C,K)`` seg heads) into the port's
parameters: the same nested structure and layout, as torch tensors on the
CPU, checked against the architecture.  Values keep their stored dtype (the
trained folds are f16, and that quantization is part of the weights);
``infer.engine.ModelBundle.from_folds`` upcasts after loading.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..models.unet3d import UNetConfig, decoder_channels, encoder_features, bottleneck_features

__all__ = ["load_pytree_npz", "params_from_jax"]

_INDEX = re.compile(r"^\d+$")
_ESCAPED = re.compile(r"^K+\d+$")
_EMPTY_DICT, _EMPTY_LIST = "__EMPTY_DICT__", "__EMPTY_LIST__"
_SENTINEL = re.compile(r"^K*__EMPTY_(DICT|LIST)__$")


def _unescape_key(k: str) -> str:
    if _ESCAPED.match(k) or (k.startswith("K") and _SENTINEL.match(k)):
        return k[1:]
    return k


def unflatten_pytree(flat: Mapping[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def densify(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {_EMPTY_DICT}:
            return {}
        if set(node) == {_EMPTY_LIST}:
            return []
        if node and all(_INDEX.match(k) for k in node):
            return [densify(node[str(i)]) for i in range(len(node))]
        return {_unescape_key(k): densify(v) for k, v in node.items()}

    return densify(root)


def load_pytree_npz(path: os.PathLike) -> Any:
    with np.load(os.fspath(path)) as z:
        return unflatten_pytree({k: z[k] for k in z.files})


_BLOCK_KEYS = ("w", "b", "scale", "shift", "mean", "var")


def _tensor(a, shape, where: str) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{where}: expected shape {tuple(shape)}, got {tuple(a.shape)}")
    return torch.from_numpy(np.array(a, order="C"))  # a copy: the tree may be read-only


def _block(tree: Mapping[str, Any], ci: int, co: int, cfg: UNetConfig, where: str):
    keys = _BLOCK_KEYS if cfg.norm == "batch" else _BLOCK_KEYS[:4]
    missing = [k for k in keys if k not in tree]
    if missing:
        raise ValueError(f"{where}: missing {missing}")
    out = {"w": _tensor(tree["w"], (*cfg.conv_kernel, ci, co), f"{where}/w")}
    for k in keys[1:]:
        out[k] = _tensor(tree[k], (co,), f"{where}/{k}")
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """The port's parameters from a reference-layout numpy tree (see module doc).

    Raises ``ValueError`` when a leaf is missing or its shape does not match
    ``cfg``'s channel plan.
    """
    enc = encoder_features(cfg)
    bneck = bottleneck_features(cfg)
    encoder: List[List[Dict[str, torch.Tensor]]] = []
    cin = cfg.in_channels
    for d, f in enumerate(enc):
        stage = tree["encoder"][d]
        if len(stage) != cfg.conv_per_stage:
            raise ValueError(f"encoder/{d}: expected {cfg.conv_per_stage} blocks, got {len(stage)}")
        encoder.append([
            _block(blk, cin if c == 0 else f, f, cfg, f"encoder/{d}/{c}")
            for c, blk in enumerate(stage)
        ])
        cin = f
    bottleneck = []
    for c, blk in enumerate(tree["bottleneck"]):
        bottleneck.append(_block(blk, cin if c == 0 else bneck, bneck, cfg, f"bottleneck/{c}"))
    decoder = []
    for u, ch in enumerate(decoder_channels(cfg)):
        st = tree["decoder"][u]
        n = len(st["blocks"])
        chans = [(2 * ch["skip"], ch["skip"])] + [(ch["skip"], ch["skip"])] * (n - 2)
        chans.append((ch["skip"], ch["out"]))
        decoder.append({
            "up": {"w": _tensor(st["up"]["w"], (ch["from_down"], *cfg.pool_kernel, ch["skip"]),
                                f"decoder/{u}/up/w")},
            "blocks": [_block(blk, ci, co, cfg, f"decoder/{u}/blocks/{i}")
                       for i, (blk, (ci, co)) in enumerate(zip(st["blocks"], chans))],
            "seg": {"w": _tensor(st["seg"]["w"], (1, 1, 1, ch["out"], cfg.num_classes),
                                 f"decoder/{u}/seg/w")},
        })
    return {"encoder": encoder, "bottleneck": bottleneck, "decoder": decoder}
