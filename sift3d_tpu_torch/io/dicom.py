"""DICOM IO via the native C++ codec (io/native/dicom.cpp).

Mirrors the reference's DCMTK wrapper surface (read_dcm / read_dcm_dir /
write_dcm / write_dcm_dir, imutil/dicom.cpp) with the same typed error
codes. The codec (a copy of the JAX package's) is compiled on demand
with g++ into ``build/native/libs3ddicom-<hash>.so`` at the root of the
checkout, keyed by a hash of the source and the flags, and written under
a temporary name first, so that processes building at once never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .errors import (DuplicateSlicesError, FileDoesNotExistError,
                     InconsistentAxesError, SIFT3DIOError,
                     UnevenSpacingError, UnsupportedFileTypeError,
                     WrapperNotCompiledError)
from .volume import Volume

_SRC = pathlib.Path(__file__).with_name("native") / "dicom.cpp"
_BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_build_error: str | None = None


def _get_lib():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise WrapperNotCompiledError(_build_error)
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    so = _BUILD / f"libs3ddicom-{h.hexdigest()[:16]}.so"
    try:
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (subprocess.CalledProcessError, OSError) as e:
        _build_error = getattr(e, "stderr", str(e)) or str(e)
        raise WrapperNotCompiledError(_build_error)

    c = ctypes
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.s3d_dcm_last_error.restype = c.c_char_p
    for name in ("s3d_dcm_query", "s3d_dcm_dir_query"):
        fn = getattr(lib, name)
        fn.restype = c.c_int
        fn.argtypes = [c.c_char_p, i32p, f64p]
    for name in ("s3d_dcm_read", "s3d_dcm_dir_read"):
        fn = getattr(lib, name)
        fn.restype = c.c_int
        fn.argtypes = [c.c_char_p, f32p]
    lib.s3d_dcm_dso_read.restype = c.c_int
    lib.s3d_dcm_dso_read.argtypes = [c.c_char_p, c.c_char_p, f32p]
    lib.s3d_dcm_write.restype = c.c_int
    lib.s3d_dcm_write.argtypes = [c.c_char_p, f32p] + [c.c_int] * 4 + \
        [c.c_double] * 3 + [c.c_char_p, c.c_int]
    lib.s3d_dcm_write_jpegls.restype = c.c_int
    lib.s3d_dcm_write_jpegls.argtypes = lib.s3d_dcm_write.argtypes
    lib.s3d_dcm_write_dir.restype = c.c_int
    lib.s3d_dcm_write_dir.argtypes = [c.c_char_p, f32p] + [c.c_int] * 4 + \
        [c.c_double] * 3
    _lib = lib
    return _lib


_ERRORS = {
    -2: FileDoesNotExistError,
    -3: UnsupportedFileTypeError,
    -4: UnevenSpacingError,
    -5: InconsistentAxesError,
    -6: DuplicateSlicesError,
}


def _check(lib, ret: int):
    if ret == 0:
        return
    msg = lib.s3d_dcm_last_error().decode("utf-8", "replace")
    raise _ERRORS.get(ret, SIFT3DIOError)(msg)


def _read(path: str, query_fn: str, read_fn: str) -> Volume:
    lib = _get_lib()
    dims = np.zeros(4, np.int32)
    units = np.zeros(3, np.float64)
    _check(lib, getattr(lib, query_fn)(path.encode(), dims, units))
    nx, ny, nz, nc = (int(d) for d in dims)
    out = np.zeros(nz * ny * nx * nc, np.float32)
    _check(lib, getattr(lib, read_fn)(path.encode(), out))
    data = out.reshape(nz, ny, nx, nc)
    if nc == 1:
        data = data[..., 0]
    return Volume(data, tuple(units))


def read_dcm(path: str) -> Volume:
    """Read a single DICOM file (read_dcm, dicom.cpp:755-825)."""
    if not os.path.exists(path):
        raise FileDoesNotExistError(path)
    return _read(path, "s3d_dcm_query", "s3d_dcm_read")


def read_dso(dso_path: str, im_dir: str) -> Volume:
    """Read a single-segment DICOM Segmentation Object's binary mask into
    the geometry of its referenced image series (read_dso, reference
    dicom.cpp:1012-1149): DSO frames map to the sorted slices by
    ReferencedSOPInstanceUID; unreferenced slices stay zero."""
    if not os.path.exists(dso_path):
        raise FileDoesNotExistError(dso_path)
    if not os.path.exists(im_dir):
        raise FileDoesNotExistError(im_dir)
    lib = _get_lib()
    dims = np.zeros(4, np.int32)
    units = np.zeros(3, np.float64)
    _check(lib, lib.s3d_dcm_dir_query(im_dir.encode(), dims, units))
    nx, ny, nz, _ = (int(d) for d in dims)
    out = np.zeros(nz * ny * nx, np.float32)
    _check(lib, lib.s3d_dcm_dso_read(dso_path.encode(), im_dir.encode(),
                                     out))
    return Volume(out.reshape(nz, ny, nx), tuple(units))


def read_dcm_dir(path: str) -> Volume:
    """Read a directory of DICOM slices (read_dcm_dir, dicom.cpp:1369-1418).

    Slices are sorted by position-dot-normal; the series must be single,
    evenly spaced (tol 5e-2 mm), and free of duplicate coordinates.
    """
    if not os.path.exists(path):
        raise FileDoesNotExistError(path)
    return _read(path, "s3d_dcm_dir_query", "s3d_dcm_dir_read")


def _prep_write(vol: Volume):
    data = np.ascontiguousarray(vol.data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    nz, ny, nx, nc = data.shape
    if nc not in (1, 3):
        # 1 channel writes MONOCHROME2; 3 write interleaved RGB - working
        # color support where the reference only declares it
        # (write_dcm_cpp rejects nc != 1 before its RGB branch,
        # dicom.cpp:1491-1495,1525-1535).
        raise UnsupportedFileTypeError(
            f"only 1- or 3-channel DICOM write is supported (got {nc})")
    ux, uy, uz = vol.units
    return data, nx, ny, nz, nc, ux, uy, uz


def write_dcm(path: str, vol: Volume, series_uid: str = "",
              instance_num: int = 1, lossless_jpeg: bool = False) -> None:
    """Write one multi-frame 8-bit DICOM file (write_dcm,
    dicom.cpp:1421-1446). Pixels are scaled by 255/max and truncated, like
    the reference (the source of its 1e-2 round-trip tolerance).

    ``lossless_jpeg`` encapsulates the frames as JPEG Lossless Process 14
    SV1 streams - the transfer syntax the reference emits through DCMTK
    (reference dicom.cpp:1748). Pixel values are identical either way
    (the codec is lossless); only the on-disk encoding changes."""
    lib = _get_lib()
    data, nx, ny, nz, nc, ux, uy, uz = _prep_write(vol)
    fn = lib.s3d_dcm_write_jpegls if lossless_jpeg else lib.s3d_dcm_write
    _check(lib, fn(path.encode(), data, nx, ny, nz, nc, ux, uy, uz,
                   series_uid.encode(), instance_num))


def write_dcm_dir(path: str, vol: Volume) -> None:
    """Write a directory of single-slice DICOM files (write_dcm_dir,
    dicom.cpp:1449-1481)."""
    lib = _get_lib()
    data, nx, ny, nz, nc, ux, uy, uz = _prep_write(vol)
    _check(lib, lib.s3d_dcm_write_dir(path.encode(), data, nx, ny, nz,
                                      nc, ux, uy, uz))
