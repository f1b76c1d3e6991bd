"""Build the CUDA sources in ``braintpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: that keeps a build to seconds)
under ``braintpu_torch/_build/``.  A library's file name carries a hash of its
source and flags, so an edited source builds anew and an unchanged one is
reused.  ``nvcc`` writes to a temporary name that is renamed into place, so
an interrupted build leaves no partial library and no lock behind.

Nothing builds at import time: the first launch of a kernel (or
:func:`build_all`) does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _ptxas_summary(log: str) -> str:
    """Registers, shared memory and spills from ``-Xptxas -v``, one line."""
    used = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    parts = [f"registers={r} smem_bytes={s}" for r, s in used]
    parts += [f"spill_stores={a} spill_loads={b}" for a, b in spills]
    return " ".join(parts) or "ptxas printed no usage"


def _start(name: str):
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    print(
        f"# built csrc/{name}.cu in {time.perf_counter() - t0:.2f}s: {_ptxas_summary(log)}",
        flush=True,
    )


def build_all() -> List[str]:
    """Build every ``csrc/*.cu`` not built yet, one ``nvcc`` each, all at once.

    Returns the names of the sources.  Raises with nvcc's output if any
    build fails.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        t0 = time.perf_counter()
        started = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
        errors = []
        for n, out, tmp, proc in started:
            try:
                _finish(n, out, tmp, proc, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return names


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = _lib_path(name)
        if not out.exists():
            t0 = time.perf_counter()
            _finish(name, *_start(name), t0)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
