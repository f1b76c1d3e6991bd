"""Fused U-Net stage convolution: the hand-written Hopper kernel ``conv_stage``.

Counterpart of ``braintpu/ops/stage_pallas.py::conv_stage``, the kernel of
the deferred-norm (GroupNorm / InstanceNorm) inference path.  One call
computes, on channels-last (NDHWC) bf16 tensors:

* ``t_k = bf16(leaky_{in_k_slope}(f32(x_k) * a_k + c_k))`` for the first
  input and the optional second (skip) input, each with its own affine and
  slope, applied only where given (without either, ``t_k = x_k``);
* ``t = concat(t1, t2)`` on channels;
* ``y = conv3d(t, w) + b`` in f32, 3x3x3, stride 1, SAME zero padding that
  lies in the transformed domain (out-of-volume voxels are zeros and are
  never transformed);
* with ``stats``: ``s1[n, c] = sum y`` and ``s2[n, c] = sum y^2`` per sample
  over the f32 ``y`` before any output activation;
* ``out = bf16(leaky_{out_slope}(y))``,

over the output planes ``out_planes = (lo, hi)`` of D only (default: all of
them): ``out`` holds those ``hi - lo`` planes and the sums cover them.  An
X-sharded forward feeds the kernel its neighbours' boundary planes and asks
for its own.

Affines are shared ``(ci,)`` or per sample ``(N, ci)``.  The CUDA source is
``csrc/conv_stage.cu``.

* :func:`conv_stage` launches the kernel for CUDA tensors, with the launch
  plan of :func:`braintpu_torch.ops.conv_plan.conv_plan`, and calls the
  plain version for CPU tensors.  There is no fallback on the card: a CUDA
  tensor the kernel (or its plan) cannot take raises.
* :func:`conv_stage_ref` is the plain PyTorch version (the reference's
  oracle ``_xla_reference``), used by the CPU path and as the kernel's
  yardstick on the card.
* ``conv_stage.launches`` counts kernel launches (not plain calls).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_plan import conv_plan

__all__ = ["conv_stage", "conv_stage_ref", "stage_supported"]


def stage_supported(shape: Tuple[int, ...], co: int, ci2: int = 0) -> bool:
    """Shapes the kernel takes.  ``shape`` is the first input's
    (N, D, H, W, ci1) and ``ci2`` the optional second input's channels:
    ci1, ci2 and co multiples of 8 (16-byte channel runs), D >= 3 and
    H, W >= 8 (the floor of the reference's ``conv_stage_supported``,
    without its TPU VMEM planner)."""
    N, D, H, W, ci1 = shape
    return (ci1 > 0 and co > 0 and ci1 % 8 == 0 and ci2 % 8 == 0 and co % 8 == 0
            and D >= 3 and H >= 8 and W >= 8)


def _check_affine(a, c, N: int, ci: int, dev, which: str) -> None:
    if (a is None) != (c is None):
        raise ValueError(f"affine of input {which}: give both a and c, or neither")
    if a is None:
        return
    for t in (a, c):
        if t.dtype != torch.float32:
            raise TypeError(f"affine of input {which} must be f32, got {t.dtype}")
        if tuple(t.shape) not in ((ci,), (N, ci)):
            raise ValueError(f"affine of input {which}: expected ({ci},) or ({N}, {ci}), "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"affine of input {which} on {t.device}, input on {dev}")


def _check(x1, w, b, x2, a1, c1, a2, c2) -> None:
    if x1.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"expected x1 (N,D,H,W,ci1) and w (3,3,3,ci,co), got {tuple(x1.shape)} and {tuple(w.shape)}")
    N, D, H, W, ci1 = (int(s) for s in x1.shape)
    ci, co = int(w.shape[3]), int(w.shape[4])
    ci2 = 0 if x2 is None else int(x2.shape[-1])
    if x2 is not None and tuple(x2.shape[:4]) != (N, D, H, W):
        raise ValueError(f"x2 {tuple(x2.shape)} does not match x1 {tuple(x1.shape)}")
    if ci1 + ci2 != ci or tuple(b.shape) != (co,):
        raise ValueError(f"channel mismatch: x1 {tuple(x1.shape)}, x2 ci={ci2}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x2 is None and (a2 is not None or c2 is not None):
        raise ValueError("an affine for input 2 without x2")
    bf16 = torch.bfloat16
    if x1.dtype != bf16 or w.dtype != bf16 or b.dtype != torch.float32 or (
            x2 is not None and x2.dtype != bf16):
        raise TypeError(f"expected bf16 x1/x2/w and f32 b; got {x1.dtype}, "
                        f"{None if x2 is None else x2.dtype}, {w.dtype}, {b.dtype}")
    if not (x1.device == w.device == b.device) or (x2 is not None and x2.device != x1.device):
        raise ValueError("tensors on different devices")
    _check_affine(a1, c1, N, ci1, x1.device, "1")
    _check_affine(a2, c2, N, ci2, x1.device, "2")


def _transform(x, a, c, slope) -> torch.Tensor:
    if a is None and slope is None:
        return x
    t = x.float()
    if a is not None:
        shape = (-1, 1, 1, 1, x.shape[-1])  # (ci,) broadcasts as (1, ci)
        t = t * a.reshape(shape) + c.reshape(shape)
    if slope is not None:
        t = torch.where(t >= 0, t, t * slope)
    return t.to(torch.bfloat16)


def conv_stage_ref(
    x1: torch.Tensor, w: torch.Tensor, b: torch.Tensor, x2: Optional[torch.Tensor] = None,
    a1=None, c1=None, a2=None, c2=None,
    in1_slope: Optional[float] = None, in2_slope: Optional[float] = None,
    out_slope: Optional[float] = None, stats: bool = False,
    out_planes: Optional[Tuple[int, int]] = None,
):
    """Plain version (the reference oracle's arithmetic): transform each
    input in f32 and round to bf16, concatenate, f32 ``F.conv3d`` + bias,
    the output planes ``out_planes``, per-sample f32 sums, output
    LeakyReLU, bf16."""
    _check(x1, w, b, x2, a1, c1, a2, c2)
    lo, hi = _window(out_planes, x1.shape[1])
    t = _transform(x1, a1, c1, in1_slope)
    if x2 is not None:
        t = torch.cat([t, _transform(x2, a2, c2, in2_slope)], dim=-1)
    y = F.conv3d(t.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2), b,
                 padding=1).permute(0, 2, 3, 4, 1)[:, lo:hi]
    s1 = s2 = None
    if stats:
        s1 = y.sum(dim=(1, 2, 3))
        s2 = (y * y).sum(dim=(1, 2, 3))
    if out_slope is not None:
        y = torch.where(y >= 0, y, y * out_slope)
    y = y.to(torch.bfloat16).contiguous()
    return (y, s1, s2) if stats else y


_AFF1, _SLOPE1, _AFF2, _SLOPE2, _OUT_SLOPE, _STATS = (1 << i for i in range(6))


def _window(out_planes, D: int) -> Tuple[int, int]:
    lo, hi = (0, int(D)) if out_planes is None else (int(v) for v in out_planes)
    if not 0 <= lo < hi <= D:
        raise ValueError(f"out_planes {out_planes} outside the {D} output planes")
    return lo, hi


def conv_stage(
    x1: torch.Tensor, w: torch.Tensor, b: torch.Tensor, x2: Optional[torch.Tensor] = None,
    a1=None, c1=None, a2=None, c2=None,
    in1_slope: Optional[float] = None, in2_slope: Optional[float] = None,
    out_slope: Optional[float] = None, stats: bool = False,
    out_planes: Optional[Tuple[int, int]] = None,
):
    """One fused stride-1 SAME 3x3x3 stage (see the module docstring).

    Args:
      x1: (N, D, H, W, ci1) bf16.
      w: (3, 3, 3, ci1 + ci2, co) bf16 (DHWIO), x1's channels first.
      b: (co,) f32.
      x2: optional (N, D, H, W, ci2) bf16 second input.
      a1/c1, a2/c2: optional f32 affines, (ci_k,) or (N, ci_k).
      in1_slope/in2_slope: LeakyReLU slopes applied after each affine.
      out_slope: LeakyReLU slope of the output.
      stats: also return per-sample (N, co) f32 sums s1 and s2 of the
        pre-activation output.
      out_planes: ``(lo, hi)``: compute output planes ``lo <= d < hi``
        only (default: every plane); y and the sums cover those planes.

    Returns:
      y (N, hi - lo, H, W, co) bf16, or (y, s1, s2) with ``stats``.  On the card
      s1 and s2 are summed with atomics, so their last bits vary from run to
      run.
    """
    _check(x1, w, b, x2, a1, c1, a2, c2)
    args = dict(x2=x2, a1=a1, c1=c1, a2=a2, c2=c2, in1_slope=in1_slope, in2_slope=in2_slope,
                out_slope=out_slope, stats=stats, out_planes=out_planes)
    if x1.device.type == "cpu":
        return conv_stage_ref(x1, w, b, **args)
    if x1.device.type != "cuda":
        raise ValueError(f"conv_stage runs on cuda or cpu tensors, not {x1.device}")
    N, D, H, W, ci1 = (int(s) for s in x1.shape)
    ci2 = 0 if x2 is None else int(x2.shape[-1])
    co = int(w.shape[4])
    lo, hi = _window(out_planes, D)
    if not stage_supported(tuple(x1.shape), co, ci2):
        raise ValueError(f"conv_stage does not take x1 {tuple(x1.shape)}, ci2={ci2} -> co={co}")
    tensors = [x1, w, b] + [t for t in (x2, a1, c1, a2, c2) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_stage needs contiguous inputs, weights and affines")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("conv_stage needs 16-byte aligned inputs, weights and affines")
    plan = conv_plan(N, D, H, W, ci1, co, ci2, stage=True)
    if plan is None:
        raise ValueError(f"no launch plan for x1 {tuple(x1.shape)}, ci2={ci2} -> co={co}")
    dev = x1.device
    y = torch.empty((N, hi - lo, H, W, co), dtype=torch.bfloat16, device=dev)
    s1 = torch.zeros((N, co), dtype=torch.float32, device=dev) if stats else None
    s2 = torch.zeros((N, co), dtype=torch.float32, device=dev) if stats else None
    flags = ((_AFF1 if a1 is not None else 0) | (_SLOPE1 if in1_slope is not None else 0)
             | (_AFF2 if a2 is not None else 0) | (_SLOPE2 if in2_slope is not None else 0)
             | (_OUT_SLOPE if out_slope is not None else 0) | (_STATS if stats else 0))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    stride = lambda t, ci: ci if (t is not None and t.dim() == 2) else 0
    rc = _build.bind("conv_stage", _ARGTYPES)(
        ptr(x1), ptr(x2), ptr(w), ptr(b), ptr(a1), ptr(c1), ptr(a2), ptr(c2),
        ptr(y), ptr(s1), ptr(s2),
        N, D, H, W, ci1, ci2, co, stride(a1, ci1), stride(a2, ci2), lo, hi,
        float(in1_slope or 0.0), float(in2_slope or 0.0), float(out_slope or 0.0), flags,
        *plan.launch_args(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"conv_stage launch failed: cudaError {rc} ({plan.describe()})")
    # the key: shapes, each affine's dimensions (2: per sample), slopes, window
    dims = [None if a is None else a.dim() for a in (a1, a2)]
    _build.count_launch(conv_stage, (N, D, H, W, ci1, ci2, co, *dims, in1_slope, in2_slope,
                                     out_slope, bool(stats), lo, hi))
    return (y, s1, s2) if stats else y


conv_stage.launches = 0

#: 11 pointers; shape, channels, affine strides and the output planes;
#: three slopes; flags, then the plan; stream
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_float] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_void_p])
