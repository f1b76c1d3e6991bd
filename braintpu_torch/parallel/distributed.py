"""Sharded training step and fold-, patch- and case-parallel inference.

Counterpart of ``braintpu/parallel/distributed.py``.  The reference jits
its programs with sharding constraints and lets the compiler insert the
collectives; here every rank runs the same code on its share and the
collectives are written out (:mod:`.collectives`):

* :func:`make_fold_parallel_forward`: each rank forwards its contiguous
  block of the (padded) fold list and one sum merges the weighted sigmoid
  maps;
* :func:`shard_train_state` / :func:`make_sharded_train_step`: the batch
  split over ``data`` (the gradient averaged over it, BatchNorm's training
  statistics taken over the global batch), the wide blocks' output channels
  over ``model`` (column parallelism: local output channels, then an
  all-gather), SGD momentum and the BatchNorm buffers in the parameters'
  layout, the gradient norm taken after the reduction;
* :class:`DataParallelPatchRunner`: sliding-window patches of many cases in
  ``data``-split batches, the probabilities gathered and blended on the
  host.

Every rank gets every result (the reference returns replicated arrays);
rank 0 is the one that writes files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..infer.engine import _map_tree
from ..models.unet3d import Sharding, UNetConfig, apply_unet, sharded_forward
from ..train.losses import deep_supervision_loss
from ..train.trainer import TrainConfig, TrainState, _merge_bn_stats, poly_lr, trainable_leaves
from .collectives import all_gather, all_reduce_sum
from .mesh import Layout, Mesh, param_shardings, replicated

__all__ = [
    "shard_train_state",
    "make_sharded_train_step",
    "DataParallelPatchRunner",
    "make_fold_parallel_forward",
    "pad_folds_for_axis",
]


def make_fold_parallel_forward(
    cfg: UNetConfig,
    mesh: Mesh,
    num_folds: int,
    axis: str = "data",
    folded: bool = False,
) -> Callable:
    """Ensemble parallelism: the fold list split over ``axis``, one sum.

    Returns ``fwd(params_padded, weights, patches) -> (B, pd, ph, pw, K)``:
    ``params_padded`` is a list of fold parameter dicts whose length is a
    multiple of the axis (:func:`pad_folds_for_axis`), ``weights`` the
    matching per-fold weights summing to 1.  Rank ``i`` of the axis forwards
    folds ``i * L/n .. (i + 1) * L/n - 1`` (the weights as they are, no copy
    to a stacked layout) and every rank gets the weighted sum.
    """
    n = mesh.shape[axis]
    comm = mesh.comm(axis)

    @torch.inference_mode()
    def call(params_padded: Sequence[Dict[str, Any]], weights: torch.Tensor,
             patches: torch.Tensor) -> torch.Tensor:
        lead = len(params_padded)
        if lead % n != 0 or weights.shape[0] != lead or lead < num_folds:
            raise ValueError(
                f"fold axis {lead} must be a multiple of mesh axis {n}, match "
                f"weights ({weights.shape[0]}) and cover num_folds={num_folds} "
                "— pad with pad_folds_for_axis first")
        per = lead // n
        lo = comm.index * per
        acc = torch.zeros(patches.shape[:-1] + (cfg.num_classes,), dtype=torch.float32,
                          device=patches.device)
        w = weights.to(device=patches.device, dtype=torch.float32)
        for f in range(lo, lo + per):
            logits = apply_unet(params_padded[f], patches, cfg, folded=folded)
            acc = acc + w[f] * torch.sigmoid(logits).float()
        return all_reduce_sum(acc, comm, kind="probs")

    return call


def pad_folds_for_axis(fold_params: Sequence[Dict[str, Any]], num_folds: int,
                       axis_size: int) -> Tuple[List[Dict[str, Any]], torch.Tensor]:
    """The fold list padded to a multiple of ``axis_size`` by tiling it (the
    pad may exceed the fold count: 5 folds on 16 ranks take 11 pads), and f32
    weights ``1 / num_folds`` on the folds, 0 on the pads."""
    pad = (-num_folds) % axis_size
    folds = list(fold_params)
    if pad:
        reps = -(-pad // num_folds)
        folds = (folds * (reps + 1))[:num_folds + pad]
    w = torch.cat([torch.full((num_folds,), 1.0 / num_folds), torch.zeros((pad,))]).float()
    return folds, w


@dataclass
class TrainStateLayout:
    """Where a sharded train state's pieces lie: the parameters' layout tree,
    the momentum buffers' (the trainable leaves', in their order) and the
    step's."""

    params: Any
    momentum: List[Layout]
    step: Layout


def _split(t: torch.Tensor, layout: Layout, mesh: Mesh) -> torch.Tensor:
    """This rank's share of a full tensor under ``layout`` (last-axis splits)."""
    if not layout.spec or layout.spec[-1] != "model":
        return t
    m = mesh.comm("model")
    n = t.shape[-1] // m.size
    return t.narrow(-1, m.index * n, n)


def _layout_leaves(layout_tree, params) -> List[Tuple[torch.Tensor, Layout, str]]:
    """``(tensor, layout, key)`` of every leaf, in tree order."""
    out: List[Tuple[torch.Tensor, Layout, str]] = []

    def walk(p, l, key=None):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], l[k], k)
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, l):
                walk(a, b, key)
        else:
            out.append((p, l, key))

    walk(params, layout_tree)
    return out


def _sgd_like(opt: torch.optim.Optimizer, leaves: List[torch.Tensor]) -> torch.optim.SGD:
    d = opt.defaults
    return torch.optim.SGD(leaves, lr=d["lr"], momentum=d["momentum"], dampening=d["dampening"],
                           weight_decay=d["weight_decay"], nesterov=d["nesterov"])


def shard_train_state(state: TrainState, cfg: UNetConfig,
                      mesh: Mesh) -> Tuple[TrainState, TrainStateLayout]:
    """This rank's share of a (full, replicated) train state, on the mesh's
    device: the wide blocks' tensors split over ``model``
    (:func:`~.mesh.param_shardings`), the rest replicated; SGD's momentum
    buffers split as their parameters, the step replicated.  Returns
    ``(sharded_state, layout)``."""
    p_sh = param_shardings(state.params, cfg, mesh)
    dev = mesh.device

    def place(t, layout):
        return _split(t.detach(), layout, mesh).to(dev, torch.float32).clone()

    def build(p, l, key=None):
        if isinstance(p, dict):
            return {k: build(p[k], l[k], k) for k in p}
        if isinstance(p, (list, tuple)):
            return [build(a, b, key) for a, b in zip(p, l)]
        return place(p, l).requires_grad_(p.requires_grad)

    params = build(state.params, p_sh)
    old = trainable_leaves(state.params)
    new = trainable_leaves(params)
    moment_layouts = [l for t, l, k in _layout_leaves(p_sh, state.params) if t.requires_grad]
    opt = _sgd_like(state.opt_state, new)
    for o, p, l in zip(old, new, moment_layouts):
        buf = state.opt_state.state.get(o, {}).get("momentum_buffer")
        if buf is not None:
            opt.state[p]["momentum_buffer"] = place(buf, l)
    return (TrainState(params=params, opt_state=opt, step=state.step),
            TrainStateLayout(params=p_sh, momentum=moment_layouts, step=replicated(mesh)))


class ShardedStep:
    """The sharded train step (:func:`make_sharded_train_step`), and the
    checkpoint I/O of a sharded state for ``train.trainer.fit``."""

    def __init__(self, mesh: Mesh, cfg: UNetConfig, tc: TrainConfig, layout: TrainStateLayout):
        self.mesh, self.cfg, self.tc, self.layout = mesh, cfg, tc, layout
        self.data = mesh.comm("data")
        self.model = mesh.comm("model")
        self.checkpoint = _ShardedCheckpoint(self)

    def _split_ids(self, params) -> frozenset:
        return frozenset(id(t) for t, l, key in _layout_leaves(self.layout.params, params)
                         if key == "w" and l.spec and l.spec[-1] == "model")

    def __call__(self, state: TrainState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        """One step on the global ``batch`` (every rank passes the same one
        and takes its ``data`` rows).  Returns ``(state, {"loss",
        "grad_norm", "step"})``, the loss averaged over the global batch."""
        cfg, tc, D = self.cfg, self.tc, self.data
        image = torch.as_tensor(batch["image"])
        labels = torch.as_tensor(batch["labels"])
        N = int(image.shape[0])
        if N % D.size:
            raise ValueError(f"batch {N} must be a multiple of the mesh's data axis {D.size}")
        rows = slice(D.index * N // D.size, (D.index + 1) * N // D.size)
        dev = self.mesh.device
        image = image[rows].to(dev, non_blocking=True)
        labels = labels[rows].to(dev, non_blocking=True)
        opt = state.opt_state
        for group in opt.param_groups:
            group["lr"] = poly_lr(tc, state.step)
        opt.zero_grad(set_to_none=True)
        sharding = Sharding(data=D, model=self.model, split=self._split_ids(state.params))
        with sharded_forward(sharding):
            heads, new_stats = apply_unet(state.params, image, cfg, train=True,
                                          deep_supervision=True, generator=generator)
            loss = deep_supervision_loss(heads, labels)
            loss.backward()
        leaves = trainable_leaves(state.params)
        grads = [p.grad for p in leaves]
        # the gradient's mean over data: one flat all-reduce
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_sum(flat, D, kind="grad")
        flat /= D.size
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        split = [l.spec and l.spec[-1] == "model" for l in self.layout.momentum]
        sq_rep = sum((g.float() ** 2).sum() for g, s in zip(grads, split) if not s)
        sq_split = torch.zeros((), device=dev) + sum(
            (g.float() ** 2).sum() for g, s in zip(grads, split) if s)
        all_reduce_sum(sq_split, self.model, kind="grad_norm")
        grad_norm = torch.sqrt(sq_rep + sq_split)
        opt.step()
        if cfg.norm == "batch":
            _merge_bn_stats(state.params, new_stats)
        state.step += 1
        loss = all_reduce_sum(loss.detach().clone(), D, kind="loss") / D.size
        return state, {"loss": loss, "grad_norm": grad_norm, "step": state.step}

    def gather_state(self, state: TrainState) -> TrainState:
        """The whole (unsharded) state on the CPU, on every rank (collective
        over ``model``)."""
        m = self.model

        def full(t, layout):
            if layout.spec and layout.spec[-1] == "model":
                t = all_gather(t.detach(), m, dim=t.dim() - 1)
            return t.detach().cpu().clone()

        def build(p, l, key=None):
            if isinstance(p, dict):
                return {k: build(p[k], l[k], k) for k in p}
            if isinstance(p, (list, tuple)):
                return [build(a, b, key) for a, b in zip(p, l)]
            return full(p, l).requires_grad_(p.requires_grad)

        params = build(state.params, self.layout.params)
        opt = _sgd_like(state.opt_state, trainable_leaves(params))
        for o, p, l in zip(trainable_leaves(state.params), trainable_leaves(params),
                           self.layout.momentum):
            buf = state.opt_state.state.get(o, {}).get("momentum_buffer")
            if buf is not None:
                opt.state[p]["momentum_buffer"] = full(buf, l)
        for g_new, g_old in zip(opt.param_groups, state.opt_state.param_groups):
            g_new["lr"] = g_old["lr"]
        return TrainState(params=params, opt_state=opt, step=state.step)

    @torch.no_grad()
    def load_state(self, state: TrainState, whole: TrainState) -> TrainState:
        """Copy this rank's share of a whole state into ``state``, in place."""
        mesh = self.mesh
        pairs = zip(_layout_leaves(self.layout.params, state.params),
                    _layout_leaves(self.layout.params, whole.params))
        for (t, l, _), (w, _, _) in pairs:
            t.copy_(_split(w, l, mesh))
        for o, w, l in zip(trainable_leaves(state.params), trainable_leaves(whole.params),
                           self.layout.momentum):
            buf = whole.opt_state.state.get(w, {}).get("momentum_buffer")
            if buf is not None:
                state.opt_state.state[o]["momentum_buffer"] = _split(buf, l, mesh).to(
                    o.device).clone()
        state.step = int(whole.step)
        return state


class _ShardedCheckpoint:
    """``fit``'s checkpoint I/O for a sharded state: every rank gathers the
    whole state, rank 0 writes it, every rank reads it back and keeps its
    share."""

    def __init__(self, step: ShardedStep):
        self.step = step

    def save(self, mgr, state: TrainState) -> None:
        whole = self.step.gather_state(state)
        if self.step.mesh.is_main:
            mgr.save(whole)
        if dist.is_initialized():
            dist.barrier()  # the other ranks read what rank 0 wrote

    def restore(self, mgr, state: TrainState) -> Optional[TrainState]:
        if mgr.latest_step() is None:  # every rank sees the same directory
            return None
        whole = self.step.gather_state(state)
        if mgr.restore(whole) is None:
            return None
        return self.step.load_state(state, whole)


def make_sharded_train_step(mesh: Mesh, cfg: UNetConfig, tc: TrainConfig,
                            state_shardings: TrainStateLayout) -> ShardedStep:
    """The train step over the mesh: the global batch split over ``data``
    (the gradient averaged over it; BatchNorm statistics global), the wide
    blocks column-parallel over ``model``; the state as
    :func:`shard_train_state` laid it out.  Call it as ``step(state, batch,
    generator=None)`` on every rank with the same global batch; it is also
    ``fit``'s ``step_fn`` (whose checkpoints it gathers and splits)."""
    return ShardedStep(mesh, cfg, tc, state_shardings)


class DataParallelPatchRunner:
    """Multi-case throughput runner: every case's sliding-window patches in
    ``data``-split batches (each rank forwards its rows of every batch), the
    probabilities gathered and blended on the host (on every rank)."""

    def __init__(self, fold_params: Sequence[Dict[str, Any]], cfg: UNetConfig, mesh: Mesh,
                 batch_size: int = 8, folded: bool = False):
        from ..infer.gaussian import gaussian_importance_map

        n = mesh.shape["data"]
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} must be a multiple of the mesh's data "
                             f"axis {n}")
        self.cfg, self.mesh, self.batch_size, self.folded = cfg, mesh, batch_size, folded
        self.comm = mesh.comm("data")
        # the folds go to the rank's device once, not per batch
        self.params = [_map_tree(lambda t: t.to(mesh.device), p) for p in fold_params]
        self.gaussian = np.asarray(gaussian_importance_map(tuple(cfg.patch_size)))

    @torch.inference_mode()
    def _forward(self, patches: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(patches.shape[:-1] + (self.cfg.num_classes,), dtype=torch.float32,
                          device=patches.device)
        for fp in self.params:
            acc += torch.sigmoid(apply_unet(fp, patches, self.cfg, folded=self.folded))
        return acc / len(self.params)

    def run(self, volumes: Sequence[np.ndarray], step_size: float = 0.5) -> List[np.ndarray]:
        """(C, X, Y, Z) preprocessed volumes -> per-case (X, Y, Z, K) probabilities."""
        from ..infer.gaussian import patch_grid

        pd, ph, pw = self.cfg.patch_size
        jobs = []  # (case index, start, patch)
        for ci, vol in enumerate(volumes):
            v = np.moveaxis(np.asarray(vol), 0, -1)
            for start in patch_grid(v.shape[:3], self.cfg.patch_size, step_size):
                x0, y0, z0 = map(int, start)
                jobs.append((ci, (x0, y0, z0), v[x0:x0 + pd, y0:y0 + ph, z0:z0 + pw]))
        acc = [np.zeros(np.asarray(v).shape[1:4] + (self.cfg.num_classes,), np.float32)
               for v in volumes]
        wsum = [np.zeros(a.shape[:3] + (1,), np.float32) for a in acc]
        g = self.gaussian[..., None]
        B, comm = self.batch_size, self.comm
        per = B // comm.size
        for i in range(0, len(jobs), B):
            chunk = jobs[i:i + B]
            batch = np.stack([p for _, _, p in chunk])
            if len(chunk) < B:  # pad to the fixed batch
                batch = np.concatenate(
                    [batch, np.zeros((B - len(chunk),) + batch.shape[1:], batch.dtype)])
            mine = torch.from_numpy(np.ascontiguousarray(
                batch[comm.index * per:(comm.index + 1) * per])).to(self.mesh.device)
            probs = all_gather(self._forward(mine), comm, dim=0).cpu().numpy()
            for (ci, (x0, y0, z0), _), p in zip(chunk, probs):
                acc[ci][x0:x0 + pd, y0:y0 + ph, z0:z0 + pw] += p * g
                wsum[ci][x0:x0 + pd, y0:y0 + ph, z0:z0 + pw] += g
        # no epsilon floor: every covered voxel has a positive weight
        return [np.divide(a, w, out=np.zeros_like(a), where=w > 0) for a, w in zip(acc, wsum)]
