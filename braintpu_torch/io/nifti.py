"""Self-contained NIfTI-1 reader/writer (no nibabel/SimpleITK dependency).

Copy of the pure-Python codec of ``braintpu/io/nifti.py``; the port has no
native decoder yet, so :func:`load_f32` and :func:`save` use this codec only.

The original pipeline leans on nibabel for every NIfTI touch.  This module
provides the same capabilities — load voxel data + affine + zooms, save with preserved
geometry — as a single-file, numpy-only implementation of the NIfTI-1
standard (348-byte header, optional gzip container).

Design notes
------------
* Arrays are returned in Fortran voxel order with shape ``dim[1:1+ndim]``,
  exactly like ``nibabel.load(...).get_fdata()``.
* ``scl_slope``/``scl_inter`` scaling is applied by :meth:`NiftiImage.get_fdata`
  (matching nibabel semantics), not by :func:`load`.
* The affine is taken from the sform if ``sform_code > 0``, else the qform,
  else a pixdim-scaled identity shifted to keep (0,0,0) at the first voxel —
  the same precedence nibabel uses.
* Writing always emits a NIfTI-1 single file (``n+1`` magic, vox_offset 352)
  and sets both sform and qform from the affine.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["NiftiImage", "load", "load_f32", "save", "NiftiError"]


class NiftiError(ValueError):
    """Raised for malformed or unsupported NIfTI files."""


# NIfTI-1 datatype codes <-> numpy dtypes.
_DTYPE_FROM_CODE = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODE_FROM_DTYPE = {np.dtype(v): k for k, v in _DTYPE_FROM_CODE.items()}

_HDR_SIZE = 348
_VOX_OFFSET = 352  # header + 4-byte extension flag


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    """Rotation matrix from the (b, c, d) quaternion fields (a derived)."""
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(a2) if a2 > 0 else 0.0
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def _rotation_to_quaternion(R: np.ndarray) -> Tuple[float, float, float]:
    """Inverse of :func:`_quaternion_to_rotation` (returns b, c, d)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        a = 0.25 * s
        b = (R[2, 1] - R[1, 2]) / s
        c = (R[0, 2] - R[2, 0]) / s
        d = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            a = (R[2, 1] - R[1, 2]) / s
            b = 0.25 * s
            c = (R[0, 1] + R[1, 0]) / s
            d = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            a = (R[0, 2] - R[2, 0]) / s
            b = (R[0, 1] + R[1, 0]) / s
            c = 0.25 * s
            d = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            a = (R[1, 0] - R[0, 1]) / s
            b = (R[0, 2] + R[2, 0]) / s
            c = (R[1, 2] + R[2, 1]) / s
            d = 0.25 * s
    if a < 0:  # canonical sign: a >= 0
        b, c, d = -b, -c, -d
    return float(b), float(c), float(d)


@dataclass
class NiftiImage:
    """An in-memory NIfTI image: raw data array + affine + header scalars."""

    dataobj: np.ndarray  # raw on-disk-typed array, Fortran voxel order
    affine: np.ndarray  # 4x4 voxel->world (RAS+, mm)
    zooms: Tuple[float, ...] = ()
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    descrip: str = ""
    # Original header bytes when loaded from disk (for faithful re-save).
    _raw_header: Optional[bytes] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.affine = np.asarray(self.affine, dtype=np.float64)
        if self.affine.shape != (4, 4):
            raise NiftiError(f"affine must be 4x4, got {self.affine.shape}")
        if not self.zooms:
            # voxel sizes = column norms of the 3x3 affine block, padded with 1s
            col = np.sqrt((self.affine[:3, :3] ** 2).sum(axis=0))
            self.zooms = tuple(float(z) for z in col) + (1.0,) * max(
                0, self.dataobj.ndim - 3
            )

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dataobj.shape

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """Data as floating point with slope/intercept applied (nibabel-compatible)."""
        data = np.asarray(self.dataobj, dtype=dtype)
        slope = self.scl_slope if self.scl_slope not in (0.0,) and not np.isnan(self.scl_slope) else 1.0
        inter = self.scl_inter if not np.isnan(self.scl_inter) else 0.0
        if slope != 1.0 or inter != 0.0:
            data = data * slope + inter
        return data

    def get_zooms(self) -> Tuple[float, ...]:
        return tuple(self.zooms[: self.dataobj.ndim])


def _parse_header(hdr: bytes) -> dict:
    if len(hdr) < _HDR_SIZE:
        raise NiftiError(f"truncated header ({len(hdr)} bytes)")
    # Detect endianness from sizeof_hdr.
    (size_le,) = struct.unpack("<i", hdr[:4])
    endian = "<" if size_le == _HDR_SIZE else ">"
    (size,) = struct.unpack(endian + "i", hdr[:4])
    if size != _HDR_SIZE:
        raise NiftiError(f"bad sizeof_hdr {size_le}; not a NIfTI-1 file")
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise NiftiError(f"bad magic {magic!r}")

    dim = struct.unpack(endian + "8h", hdr[40:56])
    datatype, bitpix = struct.unpack(endian + "2h", hdr[70:74])
    pixdim = struct.unpack(endian + "8f", hdr[76:108])
    (vox_offset,) = struct.unpack(endian + "f", hdr[108:112])
    scl_slope, scl_inter = struct.unpack(endian + "2f", hdr[112:120])
    descrip = hdr[148:228].split(b"\x00", 1)[0].decode("latin-1", "replace")
    qform_code, sform_code = struct.unpack(endian + "2h", hdr[252:256])
    quatern = struct.unpack(endian + "6f", hdr[256:280])  # b c d, qoffset xyz
    srow = np.array(struct.unpack(endian + "12f", hdr[280:328])).reshape(3, 4)

    ndim = int(dim[0])
    if not (1 <= ndim <= 7):
        raise NiftiError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    if any(s <= 0 for s in shape):
        raise NiftiError(f"bad shape {shape}")
    if datatype not in _DTYPE_FROM_CODE:
        raise NiftiError(f"unsupported datatype code {datatype}")

    return {
        "endian": endian,
        "shape": shape,
        "dtype": np.dtype(_DTYPE_FROM_CODE[datatype]).newbyteorder(endian),
        "bitpix": bitpix,
        "pixdim": pixdim,
        "vox_offset": int(vox_offset) if vox_offset else _VOX_OFFSET,
        "scl_slope": float(scl_slope),
        "scl_inter": float(scl_inter),
        "descrip": descrip,
        "qform_code": qform_code,
        "sform_code": sform_code,
        "quatern": quatern,
        "srow": srow,
        "magic": magic,
    }


def _affine_from_header(h: dict) -> np.ndarray:
    affine = np.eye(4)
    if h["sform_code"] > 0:
        affine[:3, :] = h["srow"]
    elif h["qform_code"] > 0:
        b, c, d, ox, oy, oz = h["quatern"]
        R = _quaternion_to_rotation(b, c, d)
        qfac = -1.0 if h["pixdim"][0] < 0 else 1.0
        zooms = np.abs(np.array(h["pixdim"][1:4]))
        zooms[2] *= qfac
        affine[:3, :3] = R * zooms
        affine[:3, 3] = (ox, oy, oz)
    else:
        zooms = np.abs(np.array(h["pixdim"][1:4]))
        zooms[zooms == 0] = 1.0
        affine[:3, :3] = np.diag(zooms)
        # nibabel centers the default affine on the volume; keep origin at 0
        # for analyze-style files (geometry is undefined anyway).
    return affine


def _open_maybe_gzip(path: Union[str, os.PathLike], mode: str):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: Union[str, os.PathLike]) -> NiftiImage:
    """Load a ``.nii`` or ``.nii.gz`` file into a :class:`NiftiImage`."""
    with _open_maybe_gzip(path, "rb") as f:
        raw = f.read()
    h = _parse_header(raw[:_HDR_SIZE])
    if h["magic"][:3] == b"ni1":
        raise NiftiError("two-file (.hdr/.img) NIfTI pairs are not supported")
    n_items = int(np.prod(h["shape"]))
    itemsize = h["dtype"].itemsize
    start = h["vox_offset"]
    end = start + n_items * itemsize
    if len(raw) < end:
        raise NiftiError(
            f"file truncated: need {end} bytes, have {len(raw)} (shape {h['shape']})"
        )
    flat = np.frombuffer(raw[start:end], dtype=h["dtype"])
    data = flat.reshape(h["shape"], order="F")
    ndim = len(h["shape"])
    zooms = tuple(abs(float(z)) for z in h["pixdim"][1 : 1 + ndim])
    return NiftiImage(
        dataobj=data,
        affine=_affine_from_header(h),
        zooms=zooms,
        scl_slope=h["scl_slope"],
        scl_inter=h["scl_inter"],
        descrip=h["descrip"],
        _raw_header=raw[:_HDR_SIZE],
    )


def _build_header(
    data: np.ndarray,
    affine: np.ndarray,
    descrip: str,
    scl_slope: float = 1.0,
    scl_inter: float = 0.0,
) -> bytes:
    dtype = np.dtype(data.dtype).newbyteorder("=")
    if dtype not in _CODE_FROM_DTYPE:
        raise NiftiError(f"unsupported dtype for NIfTI write: {dtype}")
    code = _CODE_FROM_DTYPE[dtype]
    bitpix = dtype.itemsize * 8

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)

    # zooms from affine column norms
    zooms3 = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    zooms3[zooms3 == 0] = 1.0
    pixdim = [1.0] + list(zooms3) + [1.0] * (7 - 3)

    # qform from affine: R = A[:3,:3] / zooms; handle improper rotation via qfac
    R = np.asarray(affine)[:3, :3] / zooms3
    qfac = 1.0
    if np.linalg.det(R) < 0:
        qfac = -1.0
        R = R.copy()
        R[:, 2] *= -1
    # orthonormalize (nearest rotation) for the quaternion representation
    u, _, vt = np.linalg.svd(R)
    R_ortho = u @ vt
    b, c, d = _rotation_to_quaternion(R_ortho)
    pixdim[0] = qfac

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    hdr[38] = ord("r")  # regular
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, float(_VOX_OFFSET))
    struct.pack_into("<2f", hdr, 112, float(scl_slope), float(scl_inter))
    # xyzt_units: mm (2) | sec (8)
    hdr[123] = 2 | 8
    desc = descrip.encode("latin-1", "replace")[:79]
    hdr[148 : 148 + len(desc)] = desc
    struct.pack_into("<2h", hdr, 252, 1, 1)  # qform_code=sform_code=1 (scanner)
    struct.pack_into(
        "<6f", hdr, 256, b, c, d, float(affine[0, 3]), float(affine[1, 3]), float(affine[2, 3])
    )
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, dtype=np.float64)[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr)


def load_f32(path) -> Tuple[np.ndarray, np.ndarray, Tuple[float, ...]]:
    """Load as ``(float32 data, affine, zooms)``."""
    img = load(path)
    return img.get_fdata(dtype=np.float32), img.affine, img.get_zooms()


def save(
    img_or_data: Union[NiftiImage, np.ndarray],
    path: Union[str, os.PathLike],
    affine: Optional[np.ndarray] = None,
    descrip: str = "braintpu",
) -> None:
    """Save an array or :class:`NiftiImage` as ``.nii`` / ``.nii.gz``.

    ``save(img, path)`` or ``save(array, path, affine=...)``.
    """
    scl_slope, scl_inter = 1.0, 0.0
    if isinstance(img_or_data, NiftiImage):
        data = np.asarray(img_or_data.dataobj)
        affine = img_or_data.affine
        descrip = img_or_data.descrip or descrip
        # dataobj holds UNSCALED on-disk values; dropping the scaling here
        # would silently change effective intensities on a load/save round-trip
        scl_slope, scl_inter = img_or_data.scl_slope, img_or_data.scl_inter
    else:
        data = np.asarray(img_or_data)
        if affine is None:
            affine = np.eye(4)

    data = np.ascontiguousarray(data.T).T  # ensure Fortran-contiguous view semantics
    hdr = _build_header(data, affine, descrip, scl_slope, scl_inter)
    # the header is packed little-endian ('<' struct formats) — the body
    # must match explicitly, not follow the host ('=' would write corrupt
    # files on a big-endian host)
    body = data.astype(data.dtype.newbyteorder("<"), copy=False).tobytes(order="F")
    payload = hdr + b"\x00\x00\x00\x00" + body

    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gz"):
        # mtime=0 for deterministic bytes
        buf = _io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0, compresslevel=4) as gz:
            gz.write(payload)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
    else:
        with open(path, "wb") as f:
            f.write(payload)
