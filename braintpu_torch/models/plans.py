"""nnU-Net plans-file ingestion.

Counterpart of ``braintpu/models/plans.py``: an nnU-Net plans dict (the
pickle nnU-Net writes; keys ``plans_per_stage``, ``base_num_features``,
``normalization_schemes`` ...) becomes a typed :class:`~.unet3d.UNetConfig`
and a :class:`PreprocessPlan`.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .unet3d import UNetConfig

__all__ = ["PreprocessPlan", "load_nnunet_plans", "config_from_plans"]


@dataclass(frozen=True)
class PreprocessPlan:
    """The preprocessing half of an nnU-Net plans file."""

    patch_size: Tuple[int, int, int]
    target_spacing: Tuple[float, float, float]
    num_modalities: int
    num_classes: int
    all_classes: Tuple[int, ...]
    normalization_schemes: Dict[int, str]
    use_mask_for_norm: Dict[int, bool]
    transpose_forward: Tuple[int, int, int]
    transpose_backward: Tuple[int, int, int]
    batch_size: int
    pool_kernel_sizes: Tuple[Tuple[int, int, int], ...]
    conv_kernel_sizes: Tuple[Tuple[int, int, int], ...]


def load_nnunet_plans(path) -> dict:
    """Unpickle a plans file (pickle runs code: load only files you trust)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _as_int_tuple(x) -> tuple:
    return tuple(int(v) for v in np.asarray(x).ravel())


def config_from_plans(plans: dict, norm: str = "batch", encoder_scale: int = 1,
                      stage: Optional[int] = None, **overrides) -> Tuple[UNetConfig, PreprocessPlan]:
    """``(UNetConfig, PreprocessPlan)`` from a loaded plans dict, at ``stage``
    (default: the highest).  Raises ``ValueError`` for an anisotropic plan:
    UNetConfig has one pool and one conv kernel for every stage, so such a
    plan needs a ``models.modular_unet.ModularUNetConfig``."""
    stages = plans["plans_per_stage"]
    stage = stage if stage is not None else max(stages.keys())
    sp = stages[stage]
    pool = tuple(tuple(int(k) for k in ks) for ks in sp["pool_op_kernel_sizes"])
    convs = tuple(tuple(int(k) for k in ks) for ks in sp["conv_kernel_sizes"])
    patch = _as_int_tuple(sp["patch_size"])
    if len(set(pool)) != 1 or len(set(convs)) != 1:
        raise ValueError(
            f"anisotropic plans (pool={pool}, convs={convs}) need per-stage kernels — build "
            "a ModularUNetConfig (models/modular_unet.py) from "
            "PreprocessPlan.pool_kernel_sizes/conv_kernel_sizes instead")
    cfg = UNetConfig(
        in_channels=int(plans["num_modalities"]),
        num_classes=int(plans["num_classes"]),
        base_features=int(plans["base_num_features"]),
        num_pool=len(pool),
        conv_per_stage=int(plans.get("conv_per_stage", 2)),
        norm=norm,
        encoder_scale=encoder_scale,
        patch_size=patch,
        pool_kernel=pool[0],
        conv_kernel=convs[0],
        **overrides,
    )
    pre = PreprocessPlan(
        patch_size=patch,
        target_spacing=tuple(float(s) for s in np.asarray(sp["current_spacing"])),
        num_modalities=int(plans["num_modalities"]),
        num_classes=int(plans["num_classes"]),
        all_classes=_as_int_tuple(plans["all_classes"]),
        normalization_schemes=dict(plans["normalization_schemes"]),
        use_mask_for_norm=dict(plans["use_mask_for_norm"]),
        transpose_forward=_as_int_tuple(plans["transpose_forward"]),
        transpose_backward=_as_int_tuple(plans["transpose_backward"]),
        batch_size=int(sp["batch_size"]),
        pool_kernel_sizes=pool,
        conv_kernel_sizes=convs,
    )
    return cfg, pre
