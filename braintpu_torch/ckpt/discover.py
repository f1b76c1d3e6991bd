"""On-disk nnU-Net results-tree discovery and bulk conversion.

Copy of ``braintpu/ckpt/discover.py``.  The reference points
``RESULTS_FOLDER`` at an nnU-Net results tree and loads 10 checkpoints from
two trainer directories:

.. code-block:: text

    <RESULTS_FOLDER>/3d_fullres/Task500_BraTS2021/
        nnUNetTrainerV2BraTSRegions_DA4_BN_BD__nnUNetPlansv2.1/
            plans.pkl
            fold_0/model_final_checkpoint.model
            ... fold_4/
        nnUNetTrainerV2BraTSRegions_DA4_BN_BD_largeUnet_Groupnorm__nnUNetPlansv2.1/
            ... same layout

This module walks that layout (at any nesting depth), maps trainer names
onto model configs, and converts every discovered fold into the
``<out>/<model>/fold_<n>.npz`` layout in one pass.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..models.unet3d import MODEL1_BN, MODEL2_GN_LARGE, UNetConfig
from .convert import convert_torch_checkpoint
from .npz import save_pytree_npz

__all__ = ["TRAINER_TO_MODEL", "DiscoveredModel", "discover_nnunet_tree", "convert_nnunet_tree"]

CHECKPOINT_NAME = "model_final_checkpoint.model"

#: trainer-directory prefixes (before the "__<plans>" separator) of the two
#: KAIST BraTS-2021 models
TRAINER_TO_MODEL = {
    "nnUNetTrainerV2BraTSRegions_DA4_BN_BD": "model1",
    "nnUNetTrainerV2BraTSRegions_DA4_BN_BD_largeUnet_Groupnorm": "model2",
}

DEFAULT_CONFIGS: Dict[str, UNetConfig] = {"model1": MODEL1_BN, "model2": MODEL2_GN_LARGE}


@dataclass
class DiscoveredModel:
    """One trainer directory's worth of fold checkpoints."""

    model: str                    # "model1" | "model2"
    trainer: str                  # full trainer-dir name (incl. plans suffix)
    trainer_dir: Path
    folds: Dict[int, Path] = field(default_factory=dict)  # fold idx -> .model
    plans_pkl: Optional[Path] = None

    @property
    def fold_indices(self) -> List[int]:
        return sorted(self.folds)


def _classify_trainer(name: str) -> Optional[str]:
    """Trainer-dir name -> model key: exact names first, else the norm-variant
    heuristic nnU-Net encodes in the name."""
    prefix = name.split("__", 1)[0]
    if prefix in TRAINER_TO_MODEL:
        return TRAINER_TO_MODEL[prefix]
    low = prefix.lower()
    if "groupnorm" in low or "largeunet" in low:
        return "model2"
    if "nnunettrainer" in low:
        return "model1"
    return None


def discover_nnunet_tree(root: os.PathLike) -> Dict[str, DiscoveredModel]:
    """Find every ``fold_*/model_final_checkpoint.model`` under *root*.

    Returns ``{"model1": DiscoveredModel, ...}``.  Unclassifiable trainer
    directories are skipped; when two classify to the same model, the one
    with more folds wins (ties: the lexicographically first trainer name).
    """
    root = Path(root)
    by_trainer: Dict[Path, DiscoveredModel] = {}
    for ckpt in sorted(root.rglob(f"fold_*/{CHECKPOINT_NAME}")):
        fold_dir = ckpt.parent
        suffix = fold_dir.name[len("fold_"):]
        if not suffix.isdigit():
            continue
        trainer_dir = fold_dir.parent
        entry = by_trainer.get(trainer_dir)
        if entry is None:
            model = _classify_trainer(trainer_dir.name)
            if model is None:
                continue
            plans = trainer_dir / "plans.pkl"
            entry = DiscoveredModel(model=model, trainer=trainer_dir.name, trainer_dir=trainer_dir,
                                    plans_pkl=plans if plans.exists() else None)
            by_trainer[trainer_dir] = entry
        entry.folds[int(suffix)] = ckpt

    out: Dict[str, DiscoveredModel] = {}
    for entry in sorted(by_trainer.values(), key=lambda e: e.trainer):
        prev = out.get(entry.model)
        if prev is None or len(entry.folds) > len(prev.folds):
            out[entry.model] = entry
    return out


def convert_nnunet_tree(
    root: os.PathLike,
    out_dir: os.PathLike,
    configs: Optional[Dict[str, UNetConfig]] = None,
    folds: Optional[List[int]] = None,
) -> List[Path]:
    """Discover and convert a whole nnU-Net results tree to ``.npz`` folds.

    Writes ``<out_dir>/<model>/fold_<n>.npz`` for every discovered fold
    (optionally only *folds*) and returns the written paths.  *configs*
    also selects which models to convert.  Raises ``FileNotFoundError`` if
    nothing was discovered, ``ValueError`` if a requested fold is missing
    or *configs* matches no discovered model.
    """
    configs = configs or DEFAULT_CONFIGS
    tree = discover_nnunet_tree(root)
    if not tree:
        raise FileNotFoundError(
            f"no nnU-Net checkpoints (fold_*/{CHECKPOINT_NAME}) found under {root!r}")
    if not any(model in configs for model in tree):
        raise ValueError(
            f"configs {sorted(configs)} match none of the discovered models {sorted(tree)}")
    written: List[Path] = []
    out_dir = Path(out_dir)
    for model, entry in sorted(tree.items()):
        cfg = configs.get(model)
        if cfg is None:
            continue  # the caller's configs select a subset
        wanted = folds if folds is not None else entry.fold_indices
        missing = [f for f in wanted if f not in entry.folds]
        if missing:
            raise ValueError(f"{model} ({entry.trainer}): requested fold(s) {missing} not on "
                             f"disk; found {entry.fold_indices}")
        for f in wanted:
            dest = out_dir / model / f"fold_{f}.npz"
            save_pytree_npz(convert_torch_checkpoint(entry.folds[f], cfg), dest)
            written.append(dest)
    return written
