"""Build the CUDA sources in ``braintpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: that keeps a build to seconds)
under ``braintpu_torch/_build/``.  A library's file name carries a hash of its
source, of every shared header ``csrc/*.cuh`` and of the flags, so an edited
source or header builds anew and an unchanged one is reused.  ``nvcc`` writes
to a temporary name that is renamed into place, so an interrupted build leaves
no partial library and no lock behind.

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
from typing import Any, Dict, List, Optional, Sequence, Set

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "bind", "build_all", "count_launch", "load_library",
           "launch_keys"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[str, Any] = {}
_count_lock = threading.Lock()

#: None, or ``{kernel name: set of launch keys}``: while a dict, every
#: launch adds its wrapper's key (the arguments that decide the launch,
#: enough to redraw random inputs of the same kind) to it, so a run can
#: list the shapes it gave each kernel
launch_keys: Optional[Dict[str, Set[tuple]]] = None


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
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _ptxas_summary(log: str) -> str:
    """Registers, shared memory and spills from ``-Xptxas -v``, one line."""
    used = re.findall(r"Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    parts = [f"registers={r}" + (f" smem_bytes={s}" if s else "") for r, s in used]
    parts += [f"spill_stores={a} spill_loads={b}" for a, b in spills]
    # wgmma serialised by ptxas (C7515, "Potential Performance Loss"): the
    # main loop would lose its overlap
    parts += sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                     if "wgmma" in ln and ("Performance Loss" in ln or "warning" in ln)})
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


def bind(name: str, argtypes: Sequence[Any]):
    """The C launcher ``<name>_launch`` of ``csrc/<name>.cu`` (built and
    loaded first if needed), returning ``int`` and taking ``argtypes``.

    Bound once per process; job threads may call it at once: each binding
    is a function object of its own whose signature is set before it is
    published.
    """
    fn = _launchers.get(name)
    if fn is None:
        lib = load_library(name)
        with _lock:
            fn = _launchers.get(name)
            if fn is None:
                fn = lib[f"{name}_launch"]  # a new object, not CDLL's shared attribute
                fn.restype = ctypes.c_int
                fn.argtypes = list(argtypes)
                _launchers[name] = fn
    return fn


def count_launch(kernel, key: Optional[tuple] = None) -> None:
    """``kernel.launches += 1`` under a lock: jobs on several threads launch
    kernels at once, and an unguarded read-modify-write can lose a count.
    ``key`` goes into :data:`launch_keys` while that is a dict."""
    with _count_lock:
        kernel.launches += 1
        if launch_keys is not None and key is not None:
            launch_keys.setdefault(kernel.__name__, set()).add(key)
