"""Training: the nnU-Net recipe (Dice + BCE deep supervision, SGD with the
poly schedule), its data loader and augmentation, checkpoints with
``torch.save``, and the synthetic case generator."""

from .losses import (
    REGION_LABELS,
    bce_with_logits,
    deep_supervision_loss,
    deep_supervision_weights,
    dice_bce_loss,
    labels_to_region_targets,
    soft_dice_loss,
)
from .checkpoint import latest_step, restore_train_state, save_train_state
from .trainer import TrainConfig, TrainState, create_train_state, fit, make_optimizer, train_step

__all__ = [
    "REGION_LABELS",
    "bce_with_logits",
    "deep_supervision_loss",
    "deep_supervision_weights",
    "dice_bce_loss",
    "labels_to_region_targets",
    "soft_dice_loss",
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "fit",
    "latest_step",
    "restore_train_state",
    "save_train_state",
    "make_optimizer",
    "train_step",
]
