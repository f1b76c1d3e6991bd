"""The ``('data', 'model')`` mesh of ranks and its layout rules.

Counterpart of ``braintpu/parallel/mesh.py``.  The reference's mesh is an
array of devices that one process drives; here it is the grid of ranks
(:mod:`.launch` starts one process per rank), each rank holding its place
in the grid, the process groups of its two axes and its device:

* ``data``: batch / case / patch / fold / mirror / X-shard parallelism; the
  gradients are averaged over it;
* ``model``: tensor parallelism, the output channels of wide conv weights
  split over it (:func:`param_shardings`).

Rank ``r`` sits at ``(r // model, r % model)``, as the reference's
``reshape(data, model)`` places device ``r``.  :func:`replicated`,
:func:`batch_sharding` and :func:`spatial_sharding` are the reference's
layout rules as plain descriptors (:class:`Layout`, whose ``spec`` is the
reference's ``PartitionSpec`` as a tuple); :func:`param_shardings` mirrors a
parameter tree with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..models.unet3d import UNetConfig
from .collectives import Comm
from .launch import rank_device

__all__ = ["Layout", "Mesh", "batch_sharding", "make_mesh", "param_shardings", "replicated",
           "spatial_sharding"]


@dataclass(eq=False)
class Mesh:
    """This rank's view of a ``data x model`` grid of ranks."""

    data: int
    model: int
    rank: int  # in the default process group (0 without one)
    device: torch.device
    backend: str  # "nccl", "gloo" or "none" (one rank, no process group)
    comms: Dict[str, Comm]  # "data" and "model" as this rank sees them
    member: bool = True  # False for a rank past data x model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def comm(self, axis: str) -> Comm:
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is outside the {self.data}x{self.model} mesh")
        return self.comms[axis]

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that does the host I/O."""
        return self.rank == 0


def make_mesh(
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    data: Optional[int] = None,
    model: Optional[int] = None,
) -> Mesh:
    """Build a ``('data', 'model')`` mesh over the first ranks.

    Defaults, as the reference: every rank; ``model=2`` when there are at
    least 4 ranks and their count is even, otherwise pure data parallelism.
    ``devices`` lists one device per mesh rank (default: the ranks' own,
    :func:`~braintpu_torch.parallel.launch.rank_device`).  Outside a process
    group only a one-rank mesh exists.  Every rank of the process group must
    call it (the axes' groups are made collectively); a rank past
    ``data x model`` gets a mesh it may not use.
    """
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    n = len(devices) if devices is not None else world
    if n > world:
        raise ValueError(f"{n} devices, but only {world} rank(s): start the ranks with "
                         "braintpu_torch.parallel.launch.spawn")
    if model is None:
        model = 2 if (data is None and n >= 4 and n % 2 == 0) else 1
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    backend = dist.get_backend() if up else "none"
    comms: Dict[str, Comm] = {}
    # every rank makes every group, in the same order (new_group is collective)
    for axis, count, size in (("data", model, data), ("model", data, model)):
        for j in range(count):
            ranks = ([d * model + j for d in range(data)] if axis == "data"
                     else [j * model + m for m in range(model)])
            group = dist.new_group(ranks) if (up and size > 1) else None
            if rank in ranks:
                comms[axis] = Comm(group, size, ranks.index(rank), backend)
    member = rank < data * model
    if devices is not None and member:
        device = torch.device(devices[rank])
    else:
        device = rank_device()
    return Mesh(data, model, rank, device, backend, comms, member)


@dataclass(frozen=True)
class Layout:
    """Where a tensor's axes lie on the mesh: ``spec[i]`` names the mesh axis
    that tensor axis ``i`` is split over, or is None (replicated); ``()``
    replicates every axis."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int) -> Layout:
    """The leading (batch) axis split over ``data``; the rest replicated."""
    return Layout(mesh, ("data",) + (None,) * (ndim - 1))


def spatial_sharding(mesh: Mesh, ndim: int, axis: int = 1) -> Layout:
    """The batch over ``data`` and spatial ``axis`` over ``model``."""
    spec = [None] * ndim
    spec[0] = "data"
    spec[axis] = "model"
    return Layout(mesh, tuple(spec))


def _shard_block(block: Dict[str, Any], mesh: Mesh, model_size: int, min_ch: int):
    """One conv block's tensors: output channels over ``model`` when wide
    enough and divisible."""
    out = {}
    for name, arr in block.items():
        cout = arr.shape[-1]
        if cout >= min_ch and cout % model_size == 0:
            out[name] = Layout(mesh, (None,) * (arr.dim() - 1) + ("model",))
        else:
            out[name] = replicated(mesh)
    return out


def _rep_tree(tree, mesh: Mesh):
    if isinstance(tree, dict):
        return {k: _rep_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rep_tree(v, mesh) for v in tree]
    return replicated(mesh)


def param_shardings(params: Any, cfg: UNetConfig, mesh: Mesh, min_ch: int = 64) -> Any:
    """A :class:`Layout` tree mirroring a U-Net parameter tree.

    The output channels of every conv / norm tensor with at least ``min_ch``
    channels are split over ``model`` (when they divide); narrow tensors,
    seg heads and every other subtree (an axial model's attention) stay
    replicated.  With ``model=1`` everything is replicated (pure data
    parallelism).
    """
    model_size = mesh.shape["model"]
    if model_size == 1:
        return _rep_tree(params, mesh)

    def conv_block(block):
        return _shard_block(block, mesh, model_size, min_ch)

    def decoder_stage(stage):
        sh = {"up": conv_block(stage["up"]), "blocks": [conv_block(b) for b in stage["blocks"]]}
        for k in stage:  # seg heads, attention subtrees: the tree is mirrored exactly
            if k not in sh:
                sh[k] = _rep_tree(stage[k], mesh)
        return sh

    out = {
        "encoder": [[conv_block(b) for b in stage] for stage in params["encoder"]],
        "bottleneck": [conv_block(b) for b in params["bottleneck"]],
        "decoder": [decoder_stage(stage) for stage in params["decoder"]],
    }
    for k in params:  # e.g. the full axial family's encoder_attn
        if k not in out:
            out[k] = _rep_tree(params[k], mesh)
    return out
