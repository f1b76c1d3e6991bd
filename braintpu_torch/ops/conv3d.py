"""Tap-merged stride-1 3x3x3 convolution: the hand-written Hopper kernel.

Counterpart of ``braintpu/ops/conv3d_pallas.py::conv3d_tap_merged``: a SAME
3x3x3 conv on channels-last (NDHWC) bf16 input with DHWIO bf16 weights, f32
bias and f32 accumulation, an optional LeakyReLU fused into the epilogue,
and bf16 output.  The CUDA source is ``csrc/conv3d_tap_merged.cu``.

* :func:`conv3d_tap_merged` launches the kernel for CUDA tensors and calls
  the plain version for CPU tensors.  There is no fallback on the card: a
  CUDA tensor the kernel cannot take raises.
* :func:`conv3d_tap_merged_ref` is the plain PyTorch version, used by the
  CPU path and as the kernel's yardstick on the card.
* ``conv3d_tap_merged.launches`` counts kernel launches (not plain calls).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3d_tap_merged", "conv3d_tap_merged_ref", "kernel_supported"]


def kernel_supported(shape: Tuple[int, ...], co: int) -> bool:
    """Shapes the kernel takes: stride-1 3x3x3 SAME conv of an
    (N, D, H, W, ci) input with ``ci`` and ``co`` multiples of 8 (16-byte
    channel runs) and H, W >= 8, D >= 3 (the reference kernel's own floor,
    ``pallas_conv_supported``)."""
    N, D, H, W, ci = shape
    return D >= 3 and H >= 8 and W >= 8 and ci % 8 == 0 and co % 8 == 0 and co > 0


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"expected x (N,D,H,W,ci) and w (3,3,3,ci,co), got {tuple(x.shape)} and {tuple(w.shape)}")
    ci, co = int(w.shape[3]), int(w.shape[4])
    if x.shape[4] != ci or tuple(b.shape) != (co,):
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError(f"expected bf16 x, bf16 w, f32 b; got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"tensors on different devices: {x.device}, {w.device}, {b.device}")


def conv3d_tap_merged_ref(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, negative_slope: Optional[float] = None
) -> torch.Tensor:
    """Plain version: f32 ``F.conv3d`` of the bf16 operands, bias, LeakyReLU,
    then the cast to bf16 (the kernel's arithmetic up to summation order)."""
    _check(x, w, b)
    xf = x.float().permute(0, 4, 1, 2, 3)
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, b, padding=1).permute(0, 2, 3, 4, 1)
    if negative_slope is not None:
        y = torch.where(y >= 0, y, y * negative_slope)
    return y.to(torch.bfloat16).contiguous()


def conv3d_tap_merged(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, negative_slope: Optional[float] = None
) -> torch.Tensor:
    """Stride-1 SAME 3x3x3 conv + bias (+ LeakyReLU) on NDHWC, bf16 out.

    Args:
      x: (N, D, H, W, ci) bf16.
      w: (3, 3, 3, ci, co) bf16 (DHWIO).
      b: (co,) f32.
      negative_slope: if not None, fuse ``leaky_relu`` with this slope.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3d_tap_merged_ref(x, w, b, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_tap_merged runs on cuda or cpu tensors, not {x.device}")
    N, D, H, W, ci = (int(s) for s in x.shape)
    co = int(w.shape[4])
    if not kernel_supported(tuple(x.shape), co):
        raise ValueError(f"kernel does not take x {tuple(x.shape)} -> co={co}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3d_tap_merged needs contiguous x, w and b")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3d_tap_merged needs 16-byte aligned x and w")
    y = torch.empty((N, D, H, W, co), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    rc = lib.conv3d_tap_merged_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        N, D, H, W, ci, co,
        float(negative_slope or 0.0), int(negative_slope is not None),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"conv3d_tap_merged launch failed: cudaError {rc}")
    conv3d_tap_merged.launches += 1
    return y


conv3d_tap_merged.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_tap_merged")
    fn = lib.conv3d_tap_merged_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib
