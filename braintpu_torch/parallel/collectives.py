"""The collectives the sharded paths need, written out by hand.

The reference leaves every collective to its compiler (a sharding
annotation becomes an all-reduce, an all-gather or a halo exchange).  Here
each is an explicit ``torch.distributed`` call over one axis of a
:class:`~braintpu_torch.parallel.mesh.Mesh`, which a :class:`Comm` names:

* :func:`all_reduce_sum`: a sum over the axis, in place;
* :func:`all_gather`: the axis' tensors concatenated along one dim;
* :func:`halo_exchange`: a rank's neighbours' boundary planes along one dim;
* :func:`all_reduce_stat`: a statistic summed in the forward whose gradient
  is summed in the backward (SyncBatchNorm's statistics);
* :func:`gather_channels`: the channel all-gather of a column-parallel conv,
  whose backward takes the rank's own slice;
* :func:`copy_to_axis`: the identity whose backward sums the gradient (the
  input of a column-parallel conv).

Routes.  ``nccl`` (distinct cards) runs ``all_reduce`` and
``all_gather_into_tensor`` on the card.  ``gloo`` runs ``all_reduce`` on CPU
tensors and on CUDA tensors (it stages them through the host), but has no
``all_gather`` for CUDA tensors: there, and for CPU tensors alike, a gather
is an ``all_reduce`` of a zeroed buffer in which each rank fills its own
slice, viewed as integers so the sum of one value and zeros is that value's
bits (``+0.0`` would turn ``-0.0`` positive).  :func:`route` names the route
that ran.  A combination no route takes (``nccl`` with CPU tensors) raises:
nothing moves to the CPU behind the caller's back.

Every call adds the bytes it hands to the collective to :data:`TRAFFIC`,
by kind (``halo``, ``stats``, ``gather``, ``reduce``), as the kernels count
their launches.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Comm", "TRAFFIC", "all_gather", "all_reduce_stat", "all_reduce_sum", "copy_to_axis",
           "gather_channels", "halo_exchange", "reset_traffic", "route"]

#: per kind: {"calls": n, "bytes": b} handed to collectives by this process
TRAFFIC: Dict[str, Dict[str, int]] = {}
_traffic_lock = threading.Lock()


def reset_traffic() -> None:
    with _traffic_lock:
        TRAFFIC.clear()


def _count(kind: str, nbytes: int) -> None:
    with _traffic_lock:
        t = TRAFFIC.setdefault(kind, {"calls": 0, "bytes": 0})
        t["calls"] += 1
        t["bytes"] += int(nbytes)


@dataclass(frozen=True)
class Comm:
    """One mesh axis as this rank sees it: the process group (None when the
    axis has one rank), its size, this rank's index along it, the backend."""

    group: Any
    size: int
    index: int
    backend: str

    @property
    def spread(self) -> bool:
        return self.size > 1


def route(comm: Comm, t: torch.Tensor) -> str:
    """The route a collective over ``comm`` takes for tensors like ``t``."""
    if not comm.spread:
        return "local"
    if comm.backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError("nccl collectives need CUDA tensors; this one is on "
                             f"{t.device} (run the ranks with gloo for CPU tensors)")
        return "nccl"
    if comm.backend == "gloo":
        return f"gloo-{t.device.type}-allreduce"
    raise ValueError(f"no collective route for backend {comm.backend!r}")


def all_reduce_sum(t: torch.Tensor, comm: Comm, kind: str = "reduce") -> torch.Tensor:
    """Sum ``t`` over the axis, in place; returns ``t``."""
    if comm.spread:
        route(comm, t)
        _count(kind, t.numel() * t.element_size())
        dist.all_reduce(t, group=comm.group)
    return t


def _as_ints(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bits as int32 (or uint8), for an exact sum with zeros."""
    flat = t.reshape(-1)
    if (flat.numel() * flat.element_size()) % 4 == 0:
        return flat.view(torch.uint8).view(torch.int32)
    return flat.view(torch.uint8)


def all_gather(t: torch.Tensor, comm: Comm, dim: int = 0, kind: str = "gather") -> torch.Tensor:
    """The axis' tensors (all of ``t``'s shape) concatenated along ``dim`` in
    rank order; bit-exact on every route."""
    if not comm.spread:
        return t
    how = route(comm, t)
    t = t.contiguous()
    if how == "nccl":
        out = torch.empty((comm.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        _count(kind, out.numel() * out.element_size())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)  # renamed in newer releases
            dist.all_gather_into_tensor(out, t, group=comm.group)
    else:
        out = torch.zeros((comm.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        out[comm.index] = t
        _count(kind, out.numel() * out.element_size())
        dist.all_reduce(_as_ints(out), group=comm.group)
    return torch.cat(out.unbind(0), dim=dim)


def halo_exchange(x: torch.Tensor, comm: Comm, dim: int = 1, left: bool = True,
                  right: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(previous rank's last plane, next rank's first plane)`` of ``x``
    along ``dim`` (each one plane thick, None past the axis' ends or when not
    asked for).  Every rank of the axis must call it with the same flags."""
    if not comm.spread or not (left or right):
        return None, None
    n = x.shape[dim]
    planes = []
    if right:  # the next rank's first plane is what my left neighbour needs of me
        planes.append(x.narrow(dim, 0, 1))
    if left:
        planes.append(x.narrow(dim, n - 1, 1))
    g = all_gather(torch.stack(planes), comm, dim=0, kind="halo")  # (size * k, ...)
    k = len(planes)
    g = g.reshape((comm.size, k) + tuple(planes[0].shape))
    want_left = g[comm.index - 1, k - 1] if (left and comm.index > 0) else None
    want_right = g[comm.index + 1, 0] if (right and comm.index + 1 < comm.size) else None
    return want_left, want_right


class _AllReduceStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return all_reduce_sum(t.clone(), comm, kind="stats")

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.comm, kind="stats_grad"), None


def all_reduce_stat(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``t`` summed over the axis (a new tensor); under autograd the gradient
    is summed over the axis as well, so every rank's share of a global
    statistic gets the gradient of every rank's use of it."""
    if not comm.spread:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceStat.apply(t, comm)
    return all_reduce_sum(t.clone(), comm, kind="stats")


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, t.shape[dim]
        return all_gather(t, comm, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.comm.index * ctx.n, ctx.n), None, None


def gather_channels(t: torch.Tensor, comm: Comm, dim: int = -1) -> torch.Tensor:
    """A column-parallel layer's local output channels gathered along
    ``dim``; the backward takes this rank's slice of the (replicated)
    gradient."""
    if not comm.spread:
        return t
    dim = dim % t.dim()
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherChannels.apply(t, comm, dim)
    return all_gather(t, comm, dim=dim)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.comm, kind="input_grad"), None


def copy_to_axis(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The identity on the input of a column-parallel layer; its backward
    sums the gradient over the axis (each rank's layer saw only its own
    output channels, so each holds a part of the input's gradient)."""
    if not comm.spread or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyToAxis.apply(t, comm)
