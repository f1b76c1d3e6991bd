"""Training losses: region-based soft Dice + BCE with deep supervision.

Counterpart of ``braintpu/train/losses.py``, in PyTorch on channels-last
tensors: the sigmoid region maps (WT/TC/ET) are trained with Dice + binary
cross-entropy (nnU-Net's ``DC_and_BCE_loss``) over every decoder head, the
coarsest head muted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "REGION_LABELS",
    "labels_to_region_targets",
    "soft_dice_loss",
    "bce_with_logits",
    "dice_bce_loss",
    "deep_supervision_weights",
    "deep_supervision_loss",
]

#: Regions in the INTERNAL label space the training data uses (1 ED, 2 NCR,
#: 3 ET): WT = {1, 2, 3}, TC = {2, 3}, ET = {3} -- region channel k is
#: painted as internal label k + 1 at inference.
REGION_LABELS: Tuple[Tuple[int, ...], ...] = ((1, 2, 3), (2, 3), (3,))


def labels_to_region_targets(labels: torch.Tensor, regions=REGION_LABELS) -> torch.Tensor:
    """Integer label map (N, D, H, W) -> region one-hot (N, D, H, W, R) f32."""
    outs = []
    for region in regions:
        m = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
        for lab in region:
            m = m | (labels == lab)
        outs.append(m)
    return torch.stack(outs, dim=-1).float()


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """1 - mean soft Dice over (batch, channel); sums over the spatial axes."""
    probs = torch.sigmoid(logits.float())
    axes = tuple(range(1, probs.dim() - 1))
    intersect = (probs * targets).sum(axes)
    denom = probs.sum(axes) + targets.sum(axes)
    dice = (2 * intersect + smooth) / (denom + smooth)
    return 1.0 - dice.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean binary cross-entropy on logits (the
    reference's ``max(x, 0) - x t + log1p(exp(-|x|))``)."""
    logits = logits.float()
    per_voxel = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per_voxel.mean()


def dice_bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return soft_dice_loss(logits, targets) + bce_with_logits(logits, targets)


def deep_supervision_weights(num_heads: int) -> torch.Tensor:
    """nnU-Net's scheme: 1/2^i per scale, the coarsest head zeroed, then
    normalized to sum 1 (f32)."""
    w = [1.0 / (2**i) for i in range(num_heads)]
    if num_heads > 1:
        w[-1] = 0.0
    w = torch.tensor(w, dtype=torch.float32)
    return w / w.sum()


def _downsample_targets(targets: torch.Tensor, factor: int) -> torch.Tensor:
    """Max-pool (N, D, H, W, R) region targets to a coarser scale (membership
    survives pooling)."""
    if factor == 1:
        return targets
    t = F.max_pool3d(targets.permute(0, 4, 1, 2, 3), factor, factor)
    return t.permute(0, 2, 3, 4, 1)


def deep_supervision_loss(head_logits: Sequence[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
    """Weighted Dice + BCE across the decoder heads (full resolution first)."""
    targets = labels_to_region_targets(labels)
    weights = deep_supervision_weights(len(head_logits)).to(targets.device)
    full = head_logits[0].shape[1]
    total = 0.0
    for w, logits in zip(weights, head_logits):
        factor = full // logits.shape[1]
        total = total + w * dice_bce_loss(logits, _downsample_targets(targets, factor))
    return total
