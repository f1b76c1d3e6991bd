"""Native host library (C++): parallel NIfTI decode, parallel gzip, exact EDT.

The port's own copy of the reference's native decoder.  ``nifti_native.cpp``
is compiled with ``g++ -O3 -shared -fPIC -std=c++17 ... -lz -lpthread`` at
first use into ``braintpu_torch/_build/`` under a name that carries a hash of
the source and the flags (an edited source builds anew; nothing is written
into the package directory) and loaded through ctypes.  ``g++`` writes to a
temporary name that is renamed into place, so concurrent first uses and an
interrupted build leave no partial library.

This is a host decoder, not a device kernel: every caller keeps its
pure-Python route (``io.nifti``, ``io.brats``, ``features.boxops``) and takes
it when :func:`native_available` is False or a call raises ``IOError``.
:func:`build_error` keeps the compiler's output of a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SOURCE",
    "build_native",
    "build_error",
    "library_path",
    "native_available",
    "read_nifti_f32",
    "read_batch_f32",
    "write_gz",
    "edt_sq",
]

SOURCE = Path(__file__).resolve().parent / "nifti_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log: Optional[str] = None  # set when a build (or load) failed

_ERRORS = {
    1: "cannot open file",
    2: "gzip decode error",
    3: "malformed NIfTI header",
    4: "unsupported datatype",
    5: "output buffer too small",
}


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return _BUILD_DIR / f"libbraintpu_nifti-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the library if it is not built yet (with ``force``, even if
    it is); returns its path.

    Raises ``RuntimeError`` with the compiler's output when the build fails.
    A process that has loaded the library keeps the copy it loaded: the new
    one is renamed into place beside it.
    """
    out = library_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native library cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *_FLAGS, str(SOURCE), "-o", str(tmp), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    lib.nifti_read_header.argtypes = [
        ctypes.c_char_p, c_i64p, ctypes.POINTER(ctypes.c_int32), c_f32p, c_f32p,
        ctypes.POINTER(ctypes.c_int32)]
    lib.nifti_read_f32.argtypes = [ctypes.c_char_p, c_f32p, ctypes.c_int64]
    lib.nifti_read_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(c_f32p), c_i64p]
    lib.nifti_write_gz.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.edt_sq_i32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    for fn in (lib.nifti_read_header, lib.nifti_read_f32, lib.nifti_read_batch_f32,
               lib.nifti_write_gz, lib.edt_sq_i32):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None once a build failed."""
    global _lib, _build_log
    with _lock:
        if _lib is not None or _build_log is not None:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build_native())))
        except (RuntimeError, OSError) as e:
            _build_log = str(e)
        return _lib


def native_available() -> bool:
    """True when the library is built and loaded (building it if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's (or loader's) message of a failed build, else None."""
    _load()
    return _build_log


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise IOError(f"native library unavailable: {_build_log}")
    return lib


def _read_header(lib, path) -> Tuple[Tuple[int, ...], np.ndarray, Tuple[float, ...]]:
    dims = (ctypes.c_int64 * 8)()
    dtype = ctypes.c_int32()
    affine = (ctypes.c_float * 12)()
    zooms = (ctypes.c_float * 3)()
    sform = ctypes.c_int32()
    rc = lib.nifti_read_header(os.fspath(path).encode(), dims, ctypes.byref(dtype), affine,
                               zooms, ctypes.byref(sform))
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    if int(sform.value) <= 0:
        # qform-only file: srow is undefined; the pure-Python codec rebuilds
        # the affine from the quaternion and pixdim fields
        raise IOError(f"{path}: sform_code=0 (qform-only): native affine unsupported")
    ndim = dims[0]
    shape = tuple(int(dims[i]) for i in range(1, 1 + ndim))
    aff = np.eye(4, dtype=np.float64)
    aff[:3, :] = np.ctypeslib.as_array(affine).reshape(3, 4)
    return shape, aff, tuple(float(z) for z in zooms)


def read_nifti_f32(path) -> Tuple[np.ndarray, np.ndarray, Tuple[float, ...]]:
    """One file -> ``(float32 data in Fortran order, affine, zooms)``, with
    ``scl_slope`` / ``scl_inter`` applied.  Raises ``IOError`` on failure."""
    lib = _require()
    shape, affine, zooms = _read_header(lib, path)
    n = int(np.prod(shape))
    flat = np.empty(n, np.float32)
    rc = lib.nifti_read_f32(os.fspath(path).encode(),
                            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    return flat.reshape(shape, order="F"), affine, zooms


def read_batch_f32(paths: Sequence) -> List[np.ndarray]:
    """Several files at once, one inflate thread per file (float32, Fortran
    order, scaling applied).  Raises ``IOError`` on any failure."""
    lib = _require()
    metas = [_read_header(lib, p) for p in paths]
    buffers = [np.empty(int(np.prod(shape)), np.float32) for shape, _, _ in metas]
    c_paths = (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * len(paths))(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for b in buffers])
    c_caps = (ctypes.c_int64 * len(paths))(*[b.size for b in buffers])
    rc = lib.nifti_read_batch_f32(c_paths, len(paths), c_outs, c_caps)
    if rc != 0:
        raise IOError(f"batch read failed: {_ERRORS.get(rc, rc)}")
    return [b.reshape(shape, order="F") for b, (shape, _, _) in zip(buffers, metas)]


def write_gz(path, payload: bytes, level: int = 4) -> None:
    """Gzip ``payload`` to ``path`` in parallel: fixed 4 MB chunks, each
    deflated on its own thread as an independent gzip member (valid RFC 1952,
    byte-deterministic: the split depends only on the payload's length).
    Raises ``IOError`` on failure."""
    lib = _require()
    rc = lib.nifti_write_gz(os.fspath(path).encode(), payload, len(payload), level, 0)
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")


def edt_sq(mask: np.ndarray) -> np.ndarray:
    """Exact squared Euclidean distance transform of a 3-D mask at unit
    sampling (int32; 0 outside the mask).

    ``np.sqrt(edt_sq(mask))`` equals ``scipy.ndimage.distance_transform_edt``
    bit for bit: the least squared distance is a unique integer and float64
    sqrt is correctly rounded.  Raises ``IOError`` when the library is
    unavailable, ``ValueError`` for a mask that is not 3-D.
    """
    # nonzero is foreground, as for scipy (a cast to uint8 would drop 0.5 or 256)
    m = np.ascontiguousarray(np.asarray(mask) != 0).view(np.uint8)
    if m.ndim != 3:
        raise ValueError(f"edt_sq expects a 3-D mask, got {m.ndim}-D")
    lib = _require()
    out = np.empty(m.shape, np.int32)
    lib.edt_sq_i32(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m.shape[0], m.shape[1],
                   m.shape[2], out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
