"""Training loop: train state, SGD with the poly schedule, one step, ``fit``.

Counterpart of ``braintpu/train/trainer.py``: nnU-Net's recipe for the same
U-Nets -- SGD with Nesterov momentum 0.99 and weight decay 3e-5, the
polynomial decay ``base_lr * (1 - t/T)^0.9``, deep-supervised Dice + BCE on
the sigmoid regions, and the BatchNorm running statistics updated by the
training forward.

* The optimizer is ``torch.optim.SGD(momentum, nesterov=True,
  weight_decay)``: weight decay added to the gradient before the momentum
  trace, the trace ``t = g + mu t``, the update ``-lr (g + mu t)`` -- optax's
  ``add_decayed_weights`` followed by ``sgd(nesterov=True)``, both taking the
  first update at ``base_lr`` (:func:`poly_lr` gives optax's
  ``polynomial_schedule`` at the same update count, in f32).
* The BatchNorm ``mean`` / ``var`` leaves (the attention blocks' too) are
  buffers outside the optimizer; every other leaf, an axial model's
  attention projections and positional embeddings included, is trained.
  The reference keeps them in its optax tree, where they take weight decay
  and momentum and are then overwritten by ``_merge_bn_stats``: the other
  leaves end the same either way.  :func:`_merge_bn_stats` writes the
  training forward's new statistics (computed from the pre-step values)
  back into the tree.
* A step is eager PyTorch plus the Hopper tap kernel (forward, with the
  library's f32 gradient); there is no ``torch.compile``.
* ``train_step`` updates the state in place (the reference's is pure) and
  returns it with ``loss``, ``grad_norm`` (the global norm over the same
  leaves as ``optax.global_norm``: the BatchNorm statistics' gradients are
  zero there) and ``step``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.unet3d import UNetConfig, apply_unet
from ..utils.device import resolve_device
from .losses import deep_supervision_loss

__all__ = ["TrainConfig", "TrainState", "create_train_state", "fit", "make_optimizer", "poly_lr",
           "train_step", "trainable_leaves"]

#: leaves the optimizer does not update (BatchNorm running statistics)
_BUFFER_KEYS = ("mean", "var")


@dataclass(frozen=True)
class TrainConfig:
    """nnU-Net default hyperparameters (the reference's fields and defaults)."""

    base_lr: float = 1e-2
    momentum: float = 0.99
    weight_decay: float = 3e-5
    max_steps: int = 1000 * 250  # 1000 epochs x 250 iterations
    poly_power: float = 0.9


@dataclass
class TrainState:
    """Parameters (a tree of f32 tensors; trainable leaves require grad), the
    optimizer state and the count of steps taken, in the reference's order.
    ``opt_state`` is the torch optimizer over the trainable leaves, which
    holds the state (the momentum buffers)."""

    params: Dict[str, Any]
    opt_state: torch.optim.Optimizer
    step: int = 0


def poly_lr(tc: TrainConfig, count: int) -> float:
    """optax's ``polynomial_schedule(base_lr, 0, poly_power, max_steps)`` at
    update count ``count`` (0 for the first update), in f32 as optax."""
    c = np.float32(min(max(int(count), 0), tc.max_steps))
    frac = np.float32(1.0) - c / np.float32(tc.max_steps)
    return float(np.float32(tc.base_lr) * frac ** np.float32(tc.poly_power))


def _walk(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, key) for v in tree]
    return fn(tree, key)


def trainable_leaves(params) -> List[torch.Tensor]:
    """Every tensor of the tree but the BatchNorm statistics, in tree order."""
    out: List[torch.Tensor] = []
    _walk(params, lambda t, k: out.append(t) if k not in _BUFFER_KEYS else None)
    return out


def make_optimizer(tc: TrainConfig, params) -> torch.optim.SGD:
    """SGD + Nesterov over the trainable leaves of ``params``, at ``base_lr``
    (the step sets each update's rate from :func:`poly_lr`).  A torch
    optimizer holds its parameters, so the port takes the tree after the
    reference's ``tc``."""
    return torch.optim.SGD(trainable_leaves(params), lr=tc.base_lr, momentum=tc.momentum,
                           dampening=0.0, weight_decay=tc.weight_decay, nesterov=True)


def create_train_state(params: Dict[str, Any], tc: TrainConfig,
                       device: Union[None, str, torch.device] = None) -> TrainState:
    """A fresh state from parameters at any float dtype: f32 copies of the
    whole tree (an axial model's attention included) on ``device`` (the card
    unless ``"cpu"`` is asked for), trainable leaves requiring grad, step 0."""
    dev = resolve_device(device)

    def leaf(t, key):
        t = torch.as_tensor(t).detach().to(dev, torch.float32).clone()
        return t.requires_grad_(key not in _BUFFER_KEYS)

    params = _walk(dict(params), leaf)
    return TrainState(params=params, opt_state=make_optimizer(tc, params), step=0)


@torch.no_grad()
def _merge_bn_stats(params: Dict[str, Any], new_stats: Dict[str, Any]) -> None:
    """Write the training forward's BatchNorm running statistics into the
    tree, in place (the reference's ``_merge_bn_stats``): the conv blocks',
    and an axial model's attention blocks' (``encoder_attn`` /
    ``decoder_attn`` in ``new_stats``, their BatchNorm under ``"bn"``)."""
    def merge(block, stats):
        if stats is not None and "mean" in block:
            block["mean"].copy_(stats["mean"])
            block["var"].copy_(stats["var"])

    for d, st in (new_stats.get("encoder_attn") or {}).items():
        merge(params["encoder_attn"][d].get("bn", {}), st)
    for u, st in (new_stats.get("decoder_attn") or {}).items():
        stage = params["decoder"][int(u)]
        if "attn_block" in stage:
            merge(stage["attn_block"].get("bn", {}), st)

    for stage, stats in zip(params["encoder"], new_stats["encoder"]):
        for b, s in zip(stage, stats):
            merge(b, s)
    for b, s in zip(params["bottleneck"], new_stats["bottleneck"]):
        merge(b, s)
    for stage, stats in zip(params["decoder"], new_stats["decoder"]):
        for b, s in zip(stage["blocks"], stats):
            merge(b, s)


def train_step(
    state: TrainState,
    batch: Dict[str, Any],
    cfg: UNetConfig,
    tc: TrainConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step, in place.

    ``batch``: ``{"image": (N, D, H, W, C) float, "labels": (N, D, H, W)
    int}`` as numpy arrays or tensors; they go to the parameters' device.
    ``generator`` feeds dropout (``cfg.dropout_rate > 0``).  Returns
    ``(state, {"loss", "grad_norm", "step"})`` with device tensors for the
    first two (reading them waits for the device).
    """
    opt = state.opt_state
    leaves = trainable_leaves(state.params)
    dev = leaves[0].device
    image = torch.as_tensor(batch["image"]).to(dev, non_blocking=True)
    labels = torch.as_tensor(batch["labels"]).to(dev, non_blocking=True)
    lr = poly_lr(tc, state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    heads, new_stats = apply_unet(state.params, image, cfg, train=True, deep_supervision=True,
                                  generator=generator)
    loss = deep_supervision_loss(heads, labels)
    loss.backward()
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in leaves]))
    opt.step()
    if cfg.norm == "batch":
        _merge_bn_stats(state.params, new_stats)
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}


def fit(
    state: TrainState,
    batches: Iterable[Dict[str, Any]],
    cfg: UNetConfig,
    tc: TrainConfig,
    num_steps: int,
    checkpoint_dir: Optional[os.PathLike] = None,
    checkpoint_every: int = 250,
    resume: bool = True,
    generator: Optional[torch.Generator] = None,
    step_fn: Optional[Callable] = None,
    on_metrics: Optional[Callable[[Dict[str, float]], None]] = None,
) -> TrainState:
    """Checkpointed training loop (restart-safe), as the reference's ``fit``.

    With ``resume``, resumes from the latest checkpoint under
    ``checkpoint_dir`` (the restored step count shortens the loop); without
    it, a checkpoint there is not read and the loop starts from ``state``'s
    step.  Saves every ``checkpoint_every`` steps and once at the end, and
    stops early when ``batches`` runs out.  ``generator`` (in the place of
    the reference's ``rng`` key) feeds dropout.  ``on_metrics`` gets each step's metrics as
    floats (which waits for the device every step).  ``step_fn(state, batch,
    generator)`` defaults to :func:`train_step` and may be a sharded step
    (``parallel.make_sharded_train_step``, called on every rank with the same
    batches): its ``checkpoint`` then does the checkpoint I/O (the whole
    state gathered, written by rank 0, read back by every rank).
    """
    ckpt = getattr(step_fn, "checkpoint", None)
    mgr = None
    if checkpoint_dir is not None:
        from .checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)
        if resume:
            restored = ckpt.restore(mgr, state) if ckpt is not None else mgr.restore(state)
            if restored is not None:
                state = restored
    if step_fn is None:
        step_fn = lambda st, b, gen: train_step(st, b, cfg, tc, gen)  # noqa: E731

    def save():
        if ckpt is not None:
            ckpt.save(mgr, state)
        else:
            mgr.save(state)

    try:
        it = iter(batches)
        step = int(state.step)
        saved = mgr.latest_step() if mgr is not None else None
        while step < num_steps:
            try:
                batch = next(it)
            except StopIteration:
                break  # a finite dataset ran out: stop (and checkpoint below)
            state, metrics = step_fn(state, batch, generator)
            step += 1
            if on_metrics is not None:
                on_metrics({k: float(v) for k, v in metrics.items()})
            if mgr is not None and step % checkpoint_every == 0:
                save()
                saved = step
        if mgr is not None and saved != step:
            save()
    finally:
        if mgr is not None:
            mgr.close()
    return state
