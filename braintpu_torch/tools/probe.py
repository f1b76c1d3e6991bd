"""Throughput probe of the port's int8 kernel on the card.

    python -m braintpu_torch.tools.probe int8 [--log PATH]

The port's counterpart of ``tools/tpu_probe.py int8``: the same four shapes
and block arguments (a square 4096^3 product and three stage-GEMM shapes),
each through :func:`braintpu_torch.ops.int8_probe.int8_matmul` on random
int8 operands drawn on the card from a fixed seed over the whole int8 range.
For each shape it prints one JSON line::

    {"probe": "int8:<label>", "ok": ..., "kernel_tops": ..., "library_tops": ...,
     "bound_ms": ..., ...}

``ok`` is true when the kernel's result is bit-equal to the plain version's
and to ``torch._int_mm``'s (cuBLASLt, the library yardstick, which the port
never calls).  ``library_rowmajor_ms`` times ``torch._int_mm`` on the
kernel's own inputs; ``library_colmajor_ms`` on a column-major copy of ``y``
(the layout cuBLASLt's int8 path favours, made once outside the timing).
``library_ms`` and ``library_tops`` are the faster of the two, the library's
best, and ``library`` names its layout.  Times are CUDA-event means over
back-to-back launches after a warm-up.  ``bound_ms`` is the least time the
card could take: the larger
of the bytes (operands read once, result written once) at 3.35 TB/s and the
operations at 1,979 TOP/s dense int8 (H100 SXM data sheet).

It writes nothing unless ``--log PATH`` is given, which appends the lines to
PATH.  It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.int8_probe import int8_matmul, int8_matmul_ref

__all__ = ["INT8_SHAPES", "HBM_BYTES_PER_S", "INT8_OPS_PER_S", "cuda_ms", "int8_bound_ms",
           "measure_int8", "run_int8", "main"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, H100 SXM

#: (label, M, K, N, bm, bn, bk): the shapes and blocks of tools/tpu_probe.py's int8 probe
INT8_SHAPES: Tuple[Tuple[str, int, int, int, int, int, int], ...] = (
    ("4096cube", 4096, 4096, 4096, 512, 512, 512),
    ("stage-l0-bn", 3072, 384, 128, 128, 128, 128),
    ("stage-l0-gn-concat", 3072, 1152, 256, 128, 256, 384),
    ("stage-l1", 1536, 1152, 384, 128, 384, 384),
)


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def int8_bound_ms(M: int, K: int, N: int) -> Tuple[float, str]:
    """Least time of an (M, K) x (K, N) int8 -> int32 product on the card,
    and what bounds it ("bytes" or "operations")."""
    t_bytes = (M * K + K * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def measure_int8(label: str, M: int, K: int, N: int, bm: int, bn: int, bk: int,
                 seed: int = 0, library: bool = True) -> Dict[str, object]:
    """One shape: the kernel against the plain version and, with ``library``,
    ``torch._int_mm`` (bit equality), and the times beside the bound.
    (cuBLASLt refuses some shapes the kernel takes, e.g. K = 80: pass
    ``library=False`` there.)"""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-128, 128, (M, K), device="cuda", dtype=torch.int8, generator=g)
    y = torch.randint(-128, 128, (K, N), device="cuda", dtype=torch.int8, generator=g)
    got = int8_matmul(x, y, bm=bm, bn=bn, bk=bk)
    ref = int8_matmul_ref(x, y)
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - ref.long()).abs().max().item())
    ok = bool(torch.equal(got, ref))
    library_ms = library_rowmajor_ms = library_colmajor_ms = library_name = None
    if library:
        yc = y.t().contiguous().t()  # column-major: cuBLASLt's int8 layout of choice
        ok = ok and bool(torch.equal(got, torch._int_mm(x, y))
                         and torch.equal(got, torch._int_mm(x, yc)))
        library_rowmajor_ms = cuda_ms(lambda: torch._int_mm(x, y))
        library_colmajor_ms = cuda_ms(lambda: torch._int_mm(x, yc))
        library_ms = min(library_rowmajor_ms, library_colmajor_ms)
        library_name = "torch._int_mm, y " + (
            "column-major" if library_colmajor_ms <= library_rowmajor_ms else "row-major")
    kernel_ms = cuda_ms(lambda: int8_matmul(x, y, bm=bm, bn=bn, bk=bk))
    plain_ms = cuda_ms(lambda: int8_matmul_ref(x, y), iters=5, warmup=1)
    bound_ms, bound_by = int8_bound_ms(M, K, N)
    ops = 2 * M * K * N
    return {
        "probe": f"int8:{label}", "ok": ok, "shape": [M, K, N], "blocks": [bm, bn, bk],
        "kernel_tops": ops / kernel_ms / 1e9,
        "library_tops": ops / library_ms / 1e9 if library_ms else None,
        "bound_ms": bound_ms, "bound_by": bound_by, "kernel_ms": kernel_ms,
        "library_ms": library_ms, "library_rowmajor_ms": library_rowmajor_ms,
        "library_colmajor_ms": library_colmajor_ms, "plain_ms": plain_ms,
        "library": library_name,
        "max_abs_err": max_abs_err,
    }


def _card() -> Dict[str, object]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip().splitlines()[0]}


def run_int8(log: Optional[str] = None) -> List[Dict[str, object]]:
    """Measure every shape of :data:`INT8_SHAPES`, print one JSON line each
    (and append them to ``log``); returns the records."""
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device; the int8 probe measures the card only")
    card = _card()
    records = []
    for i, (label, M, K, N, bm, bn, bk) in enumerate(INT8_SHAPES):
        rec = {**measure_int8(label, M, K, N, bm, bn, bk, seed=i), "device": card}
        line = json.dumps(rec)
        print(line, flush=True)
        if log:
            with open(log, "a") as f:
                f.write(line + "\n")
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="braintpu_torch.tools.probe", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=["int8"])
    ap.add_argument("--log", metavar="PATH", help="append the JSON lines to PATH")
    args = ap.parse_args(argv)
    records = run_int8(args.log)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
