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
CPU, checked against the architecture.  An axial tree's attention subtrees
(``encoder_attn``, a decoder stage's ``attn`` / ``attn_block``, their
BatchNorm and a converted checkpoint's ``out_b``) are carried as well, each
where ``models.unet3d.attention_plan`` puts it; a missing or extra subtree
raises.  Values keep their stored dtype (the
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

from ..models.unet3d import (UNetConfig, attention_plan, bottleneck_features, decoder_channels,
                             encoder_features)

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


def _keys(tree: Mapping[str, Any], want, where: str, optional=()) -> None:
    """Raise unless the dict's keys are ``want`` plus any of ``optional``."""
    have = set(tree)
    if not set(want) <= have or not have <= set(want) | set(optional):
        raise ValueError(f"{where}: keys {sorted(have)}, expected {sorted(want)}"
                         + (f" (optional {sorted(optional)})" if optional else ""))


def _attention(tree: Mapping[str, Any], spec: Dict[str, Any], where: str) -> Dict[str, Any]:
    """One axial attention (positional embeddings, three axes' projections
    and their optional output bias), shape-checked against its spec: ``qkv``
    (C, 3 inner) and ``out`` (inner, C) with ``inner`` a multiple of the
    level's ``dim_head`` (the head count is the checkpoint's own)."""
    C, shape = spec["channels"], spec["shape"]
    _keys(tree, ("pos", "axes"), where)
    _keys(tree["pos"], ("d", "h", "w"), f"{where}/pos")
    pos = {k: _tensor(tree["pos"][k], (n, C), f"{where}/pos/{k}") for k, n in zip("dhw", shape)}
    if len(tree["axes"]) != 3:
        raise ValueError(f"{where}/axes: expected 3 axes, got {len(tree['axes'])}")
    axes = []
    for i, ax in enumerate(tree["axes"]):
        at = f"{where}/axes/{i}"
        _keys(ax, ("qkv", "out"), at, optional=("out_b",))
        inner = np.shape(ax["out"])[0]
        if inner <= 0 or inner % spec["dim_head"]:
            raise ValueError(f"{at}/out: inner width {inner} is not a multiple of dim_head "
                             f"{spec['dim_head']}")
        out = {"qkv": _tensor(ax["qkv"], (C, 3 * inner), f"{at}/qkv"),
               "out": _tensor(ax["out"], (inner, C), f"{at}/out")}
        if "out_b" in ax:
            out["out_b"] = _tensor(ax["out_b"], (C,), f"{at}/out_b")
        axes.append(out)
    return {"pos": pos, "axes": axes}


def _attention_subtree(tree: Mapping[str, Any], spec: Dict[str, Any], cfg: UNetConfig,
                       where: str) -> Dict[str, Any]:
    """A decoder-variant ``attn`` or an AxialAttention3D ``attn_block`` (its
    attention and, with ``cfg.axial_bn``, its BatchNorm)."""
    if spec["kind"] == "attn":
        return _attention(tree, spec, where)
    _keys(tree, ("attn", "bn") if cfg.axial_bn else ("attn",), where)
    out = {"attn": _attention(tree["attn"], spec, f"{where}/attn")}
    if cfg.axial_bn:
        _keys(tree["bn"], _BLOCK_KEYS[2:], f"{where}/bn")
        out["bn"] = {k: _tensor(tree["bn"][k], (spec["channels"],), f"{where}/bn/{k}")
                     for k in _BLOCK_KEYS[2:]}
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """The port's parameters from a reference-layout numpy tree (see module doc).

    Raises ``ValueError`` when a leaf or subtree is missing or extra, or a
    shape does not match ``cfg``'s channel plan.
    """
    enc = encoder_features(cfg)
    bneck = bottleneck_features(cfg)
    plan = attention_plan(cfg)
    _keys(tree, ("encoder", "bottleneck", "decoder") + (("encoder_attn",) if plan["encoder"]
                                                        else ()), "params")
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
        spec = plan["decoder"].get(u)
        _keys(st, ("up", "blocks", "seg") + ((spec["kind"],) if spec else ()), f"decoder/{u}")
        n = len(st["blocks"])
        chans = [(2 * ch["skip"], ch["skip"])] + [(ch["skip"], ch["skip"])] * (n - 2)
        chans.append((ch["skip"], ch["out"]))
        stage = {
            "up": {"w": _tensor(st["up"]["w"], (ch["from_down"], *cfg.pool_kernel, ch["skip"]),
                                f"decoder/{u}/up/w")},
            "blocks": [_block(blk, ci, co, cfg, f"decoder/{u}/blocks/{i}")
                       for i, (blk, (ci, co)) in enumerate(zip(st["blocks"], chans))],
            "seg": {"w": _tensor(st["seg"]["w"], (1, 1, 1, ch["out"], cfg.num_classes),
                                 f"decoder/{u}/seg/w")},
        }
        if spec:
            stage[spec["kind"]] = _attention_subtree(st[spec["kind"]], spec, cfg,
                                                     f"decoder/{u}/{spec['kind']}")
        decoder.append(stage)
    out = {"encoder": encoder, "bottleneck": bottleneck, "decoder": decoder}
    if plan["encoder"]:
        _keys(tree["encoder_attn"], [str(d) for d in plan["encoder"]], "encoder_attn")
        out["encoder_attn"] = {
            str(d): _attention_subtree(tree["encoder_attn"][str(d)], s, cfg, f"encoder_attn/{d}")
            for d, s in plan["encoder"].items()}
    return out


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

    tree = walk(params)
    params_from_jax(tree, cfg)  # raises on a missing or extra leaf or a shape off the plan
    return tree
