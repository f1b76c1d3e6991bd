"""Blocked int8 matrix product: the hand-written Hopper kernel ``int8_matmul``.

Counterpart of ``braintpu/ops/int8_probe.py::int8_matmul``: (M, K) int8 x
(K, N) int8 -> (M, N) int32, exact.  Like the reference it is a throughput
probe with no production caller; ``python -m braintpu_torch.tools.probe
int8`` runs it.  The CUDA source is ``csrc/int8_matmul.cu``.  Two routes,
chosen by :func:`int8_route` from the shapes and addresses alone:

* ``"wgmma"`` (K % 16 == 0, N % 16 == 0, both operands 16-byte aligned,
  as TMA needs): a transpose kernel writes ``y^T`` into scratch allocated
  here, then a persistent wgmma GEMM (m64n256k32 s8, TMA ring) takes both
  operands K-major.  Two launches per call.
* ``"bytes"``: every other valid call, one launch of the byte-load
  ``mma.sync`` kernel.

* :func:`int8_matmul` launches the kernel for CUDA tensors and calls the
  plain version for CPU tensors.  There is no fallback on the card: the
  kernel takes every valid call (any M, N, K; strided operands are made
  contiguous first), and an invalid one raises on both devices alike.
* :func:`int8_matmul_ref` is the plain PyTorch version, used by the CPU path
  and as the kernel's yardstick on the card.
* ``int8_matmul.launches`` counts the calls that reached the kernels (one
  per call on either route, though the fast route launches two kernels),
  not plain calls.

The reference's block sizes ``bm``, ``bn`` and ``bk`` (512 by default) only
gate validity here, with the reference's own rule (M, N and K divisible by
them), so the same calls are valid and the same calls raise.  The Hopper
tile is the kernel's own choice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_ref", "int8_route", "SMS", "G_BM", "G_BN"]

SMS = 132         # streaming multiprocessors of an H100 SXM: the GEMM's persistent grid
G_BM, G_BN = 128, 256  # the wgmma GEMM's output tile (csrc/int8_matmul.cu)


def int8_route(M: int, N: int, K: int, x_ptr: int = 0, y_ptr: int = 0) -> str:
    """``"wgmma"`` where TMA can read both operands (K and N multiples of
    16, 16-byte aligned addresses), else ``"bytes"``."""
    if K % 16 == 0 and N % 16 == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0:
        return "wgmma"
    return "bytes"


def int8_matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version: exact int32 product.

    On the CPU it is an int32 ``mm``.  CUDA has no integer ``mm``, so on the
    card it runs in float64 and casts to int32, which is exact while every
    partial sum stays below 2**53 (K * 128**2 < 2**53: any K the card holds).
    """
    if x.device.type == "cpu":
        return x.to(torch.int32) @ y.to(torch.int32)
    return (x.double() @ y.double()).to(torch.int32)


def _check(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int) -> None:
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"expected x (M, K) and y (K, N), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.int8 or y.dtype != torch.int8:
        raise TypeError(f"expected int8 x and y; got {x.dtype}, {y.dtype}")
    M, K = x.shape
    N = y.shape[1]
    if M % bm or N % bn or K % bk:
        raise ValueError(f"M, N, K = {M}, {N}, {K} must divide by bm, bn, bk = {bm}, {bn}, {bk}")
    if x.device != y.device:
        raise ValueError(f"tensors on different devices: {x.device}, {y.device}")


def int8_matmul(x: torch.Tensor, y: torch.Tensor, bm: int = 512, bn: int = 512,
                bk: int = 512) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32."""
    _check(x, y, bm, bn, bk)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, not {x.device}")
    x, y = x.contiguous(), y.contiguous()
    M, K = (int(s) for s in x.shape)
    N = int(y.shape[1])
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    launch = _build.bind("int8_matmul", _ARGTYPES)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if int8_route(M, N, K, x.data_ptr(), y.data_ptr()) == "wgmma":
        yt = x.new_empty((N, K))
        tiles = -(-M // G_BM) * -(-N // G_BN)
        rc = launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, yt.data_ptr(),
                    min(tiles, SMS), stream)
    else:
        rc = launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, None, 0, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {rc}")
    _build.count_launch(int8_matmul)
    return out


int8_matmul.launches = 0

#: x, y, out; M, N, K; the transpose buffer (or NULL), the persistent grid; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                                          ctypes.c_void_p]
