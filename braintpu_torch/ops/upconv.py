"""2x2x2 stride-2 transposed convolution: the hand-written Hopper kernel ``upconv2x``.

Counterpart of ``braintpu/ops/upconv_pallas.py::upconv2x``: the decoder
up-convolution without bias,
``out[n, 2d+kd, 2h+kh, 2w+kw, c] = sum_ci x[n, d, h, w, ci] * w[ci, kd, kh, kw, c]``,
on channels-last (NDHWC) bf16 input with ``(ci, 2, 2, 2, co)`` bf16 weights,
f32 accumulation and bf16 output.  The windows do not overlap, so it is one
GEMM (ci -> 8 co) whose result is pixel-shuffled into the 2x output; the
kernel writes the shuffle from its epilogue (TMA stores of whole output
runs).  The CUDA source is ``csrc/upconv2x.cu``, its launch plan
:func:`braintpu_torch.ops.upconv_plan.upconv_plan`.

* :func:`upconv2x` launches the kernel for CUDA tensors and calls the plain
  version for CPU tensors.  There is no fallback on the card: a CUDA tensor
  the kernel cannot take raises.
* :func:`upconv2x_ref` is the plain PyTorch version (an f32 matmul of the
  operands rounded to the compute dtype, then the pixel shuffle), used by
  the CPU path, by f32 configs, and as the kernel's yardstick on the card.
* ``upconv2x.launches`` counts kernel launches (not plain calls).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from . import _build
from .upconv_plan import upconv_plan

__all__ = ["upconv2x", "upconv2x_ref", "upconv_supported"]


def upconv_supported(shape: Tuple[int, ...], co: int) -> bool:
    """Shapes the kernel takes: ci and co multiples of 8 (16-byte channel
    runs), any spatial size.  (The reference's ``upconv2x_supported`` also
    asks H, W >= 8 and a band that fits a TPU core's VMEM; the Hopper kernel
    needs neither.)"""
    return shape[-1] > 0 and co > 0 and shape[-1] % 8 == 0 and co % 8 == 0


def upconv2x_ref(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """Plain version: ``x`` and ``w`` rounded to ``dtype``, one f32 GEMM
    (ci -> 8 co), the result rounded to ``dtype`` and pixel-shuffled."""
    ci, kd, kh, kw, co = w.shape
    N, D, H, W, _ = x.shape
    y = x.to(dtype).reshape(-1, ci).float() @ w.to(dtype).reshape(ci, -1).float()
    y = y.to(dtype).view(N, D, H, W, kd, kh, kw, co)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(N, D * kd, H * kh, W * kw, co)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[1:4]) != (2, 2, 2):
        raise ValueError(
            f"expected x (N,D,H,W,ci) and w (ci,2,2,2,co), got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[4] != w.shape[0]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 x and w; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"tensors on different devices: {x.device}, {w.device}")


def upconv2x(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, ci) bf16 x (ci, 2, 2, 2, co) bf16 -> (N, 2D, 2H, 2W, co) bf16."""
    _check(x, w)
    if x.device.type == "cpu":
        return upconv2x_ref(x, w, torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"upconv2x runs on cuda or cpu tensors, not {x.device}")
    N, D, H, W, ci = x.shape
    co = w.shape[4]
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("upconv2x needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("upconv2x needs 16-byte aligned x and w")
    y = x.new_empty((N, 2 * D, 2 * H, 2 * W, co))
    if y.numel() == 0:
        return y
    # no plan: a shape upconv_supported refuses, or N*2D past a TMA coordinate
    plan, args = _plan_args(N, D, H, W, ci, co)
    if plan is None:
        raise ValueError(f"upconv2x does not take x {tuple(x.shape)} -> co={co}")
    rc = _build.bind("upconv2x", _ARGTYPES)(x.data_ptr(), w.data_ptr(), y.data_ptr(), args,
                                            torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"upconv2x launch failed: cudaError {rc} ({plan.describe()})")
    _build.count_launch(upconv2x, (int(N), int(D), int(H), int(W), int(ci), int(co)))
    return y


upconv2x.launches = 0


@lru_cache(maxsize=None)
def _plan_args(N: int, D: int, H: int, W: int, ci: int, co: int):
    """The plan of a shape and the launcher's argument block: the shape, then
    ``UpconvPlan.launch_args()``, as one int64 array (one ctypes argument
    instead of seventeen: host time per call)."""
    plan = upconv_plan(N, D, H, W, ci, co)
    if plan is None:
        return None, None
    return plan, (ctypes.c_longlong * 14)(N, D, H, W, ci, co, *plan.launch_args())


#: x, w, y, the argument block of _plan_args, the raw stream handle
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
