"""The reference package's ``.npz`` checkpoints, read and written, and the
weights carried across.

:func:`load_pytree_npz` and :func:`save_pytree_npz` are copies of
``braintpu/ckpt/convert.py``'s: the flat ``a/b/c``-keyed npz
(``results/trained_synth/checkpoints/model{1,2}/fold_N.npz``) holds nested
dicts and lists of numpy arrays, with dict keys that look like list indices
escaped by a leading ``K`` and empty containers kept by marker keys, so a
file written by either package loads equal in the other.

:func:`params_from_jax` turns such a tree (DHWIO conv kernels,
``(Ci,2,2,2,Co)`` up-convs, ``(1,1,1,C,K)`` seg heads) into the port's
parameters: the same nested structure and layout, as torch tensors on the
CPU, checked against the architecture.  Values keep their stored dtype (the
trained folds are f16, and that quantization is part of the weights);
``infer.engine.ModelBundle.from_folds`` upcasts after loading.
:func:`params_to_jax` is its inverse: the port's parameters (a trained
fold, say) as a reference-layout numpy tree that :func:`save_pytree_npz`
writes and the reference reads.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..models.unet3d import UNetConfig, decoder_channels, encoder_features, bottleneck_features

__all__ = ["flatten_pytree", "load_pytree_npz", "params_from_jax", "params_to_jax",
           "save_pytree_npz", "unflatten_pytree"]

_INDEX = re.compile(r"^\d+$")
_ESCAPED = re.compile(r"^K+\d+$")
_EMPTY_DICT, _EMPTY_LIST = "__EMPTY_DICT__", "__EMPTY_LIST__"
_SENTINEL = re.compile(r"^K*__EMPTY_(DICT|LIST)__$")


def _escape_key(k: str) -> str:
    """Dict keys that could be mistaken for list indices (or markers) gain
    one leading ``K``; :func:`unflatten_pytree` strips it."""
    if _INDEX.match(k) or _ESCAPED.match(k) or _SENTINEL.match(k):
        return "K" + k
    return k


def _unescape_key(k: str) -> str:
    if _ESCAPED.match(k) or (k.startswith("K") and _SENTINEL.match(k)):
        return k[1:]
    return k


def flatten_pytree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists / tuples of arrays -> ``{"a/0/b": array}``; an
    empty container becomes one marker key with an empty bool array."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT}"] = np.zeros(0, np.bool_)
            return out
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{_escape_key(str(k))}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST}"] = np.zeros(0, np.bool_)
            return out
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def save_pytree_npz(params: Any, path: os.PathLike) -> None:
    """Write a numpy tree (e.g. :func:`params_to_jax`'s) as a compressed npz."""
    flat = flatten_pytree(params)
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    np.savez_compressed(os.fspath(path), **flat)


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


def _numpy(t) -> np.ndarray:
    """A tensor (or array) as a numpy array of its dtype; bf16, which numpy
    lacks, as f32 (exact)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.asarray(t)


def params_to_jax(params: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the port's parameters as a
    reference-layout tree of numpy arrays (each leaf's dtype kept, bf16 as
    f32), checked against ``cfg`` the same way.  ``save_pytree_npz`` writes
    it as a fold the reference's ``load_pytree_npz`` reads."""
    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _numpy(node)

    tree = walk({k: params[k] for k in ("encoder", "bottleneck", "decoder")})
    params_from_jax(tree, cfg)  # raises on a missing leaf or a shape off the channel plan
    return tree
