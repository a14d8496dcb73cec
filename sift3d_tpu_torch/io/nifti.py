"""Minimal NIFTI-1 reader/writer (no external dependencies).

Semantics match the reference's nifticlib wrapper (imutil/nifti.c):

- read (nifti.c:51-167): dimensionality = last dim > 1; >4D rejected;
  a 4th dimension becomes channels; units copied from pixdim; data scaled
  by scl_slope (0 treated as 1) and scl_inter in double, stored float32;
  all integer widths plus float32/float64 supported.
- write (nifti.c:170-221): always FLOAT32 with slope 1 / intercept 0;
  multi-channel images become 4D with dt = 0.

Both .nii and .nii.gz are handled (zlib), either endianness on read.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .errors import FileDoesNotExistError, UnsupportedFileTypeError
from .volume import Volume

_HDR_SIZE = 348

# NIFTI-1 datatype codes -> numpy dtypes (nifti1.h standard values)
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DT_FLOAT32 = 16


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _img_pair(path: str):
    """(hdr_path, img_path) for an ANALYZE / NIFTI-pair .img path."""
    gz = ".gz" if str(path).endswith(".gz") else ""
    stem = os.path.splitext(path[:-3] if gz else path)[0]
    hdr = stem + ".hdr" + gz
    if not os.path.exists(hdr):
        hdr = stem + ".hdr"         # mixed compression: plain .hdr
    return hdr, path


def read_nii(path: str) -> Volume:
    """Read a .nii / .nii.gz file - or an ANALYZE / NIFTI-1 pair given as
    .img / .img.gz (the reference routes .img through nifticlib the same
    way, imutil.c:1181-1185) - into a Volume."""
    if not os.path.exists(path):
        raise FileDoesNotExistError(path)
    lower = str(path).lower()
    is_img = lower.endswith(".img") or lower.endswith(".img.gz")
    hdr_path = _img_pair(path)[0] if is_img else path
    if not os.path.exists(hdr_path):
        raise FileDoesNotExistError(hdr_path)
    with _open(hdr_path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise UnsupportedFileTypeError(f"{path}: truncated header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        bo = "<"
        if sizeof_hdr != _HDR_SIZE:
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            bo = ">"
            if sizeof_hdr != _HDR_SIZE:
                raise UnsupportedFileTypeError(
                    f"{path}: not a NIFTI-1/ANALYZE file")
        magic = hdr[344:348]
        # Blank magic = ANALYZE 7.5 (same header layout; scl_slope /
        # scl_inter are "funused" fields there and must be ignored).
        is_analyze = magic[:3] not in (b"n+1", b"ni1")
        if is_analyze and not is_img:
            raise UnsupportedFileTypeError(f"{path}: bad magic {magic!r}")
        dim = struct.unpack_from(bo + "8h", hdr, 40)
        datatype = struct.unpack_from(bo + "h", hdr, 70)[0]
        pixdim = struct.unpack_from(bo + "8f", hdr, 76)
        vox_offset = struct.unpack_from(bo + "f", hdr, 108)[0]
        scl_slope = struct.unpack_from(bo + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(bo + "f", hdr, 116)[0]

        # Dimensionality = last dimension > 1 (nifti.c:66-80).
        ndim = dim[0]
        dims = [max(int(d), 1) for d in dim[1:8]]
        dim_counter = 0
        for i in range(min(ndim, 7), 0, -1):
            if dim[i] > 1:
                dim_counter = i
                break
        if dim_counter > 4:
            raise UnsupportedFileTypeError(
                f"{path}: unsupported dimensionality {dim_counter}")

        if datatype not in _DTYPES:
            raise UnsupportedFileTypeError(
                f"{path}: unsupported datatype code {datatype}")
        dt = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

        nx, ny, nz = dims[0], dims[1], dims[2]
        nc = dims[3] if dim_counter == 4 else 1
        count = nx * ny * nz * nc

        # NIFTI-1 pairs (ni1 magic) honor vox_offset inside the .img
        # payload (nifticlib does the same); ANALYZE pairs start at 0.
        img_off = 0 if is_analyze else int(vox_offset)
        if is_img:
            with _open(path, "rb") as g:
                if img_off:
                    g.seek(img_off)
                raw = g.read(count * dt.itemsize)
        elif magic[:3] == b"ni1":   # .hdr given; data in separate .img
            img_path = os.path.splitext(
                path[:-3] if path.endswith(".gz") else path)[0] + ".img"
            with _open(img_path + (".gz" if path.endswith(".gz") else ""),
                       "rb") as g:
                if img_off:
                    g.seek(img_off)
                raw = g.read(count * dt.itemsize)
        else:
            f.seek(int(vox_offset))
            raw = f.read(count * dt.itemsize)

    arr = np.frombuffer(raw, dtype=dt, count=count)
    # NIFTI order: x fastest, then y, z, t -> (t=c, z, y, x)
    arr = arr.reshape(nc, nz, ny, nx)

    if is_analyze:
        slope, scl_inter = 1.0, 0.0   # funused fields in ANALYZE 7.5
    else:
        slope = 1.0 if scl_slope == 0.0 else float(scl_slope)
    data = (arr.astype(np.float64) * slope +
            float(scl_inter)).astype(np.float32)
    data = np.moveaxis(data, 0, -1)                       # (z, y, x, c)
    if nc == 1:
        data = data[..., 0]

    units = tuple(float(abs(pixdim[i])) or 1.0 for i in (1, 2, 3))
    return Volume(data=np.ascontiguousarray(data), units=units)


def write_nii(path: str, vol: Volume) -> None:
    """Write a Volume as .nii / .nii.gz (always float32, slope 1), or as
    a NIFTI-1 pair (.hdr + .img, the modern ANALYZE encoding nifticlib
    emits for .img paths) when given a .img / .img.gz path."""
    data = np.asarray(vol.data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    nz, ny, nx, nc = data.shape
    multi = nc > 1

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    ndim = 4 if multi else 3
    dim = [ndim, nx, ny, nz, nc if multi else 1, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DT_FLOAT32)
    struct.pack_into("<h", hdr, 72, 32)                   # bitpix
    ux, uy, uz = vol.units
    pixdim = [1.0, ux, uy, uz, 0.0 if multi else 1.0, 1.0, 1.0, 1.0]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    lower = str(path).lower()
    is_img = lower.endswith(".img") or lower.endswith(".img.gz")
    struct.pack_into("<f", hdr, 108, 0.0 if is_img else 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                 # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                 # scl_inter
    struct.pack_into("<b", hdr, 123, 2)                   # xyzt_units: mm
    # qform/sform codes 0; qfac in pixdim[0] = 1
    struct.pack_into("<4s", hdr, 344, b"ni1\x00" if is_img else b"n+1\x00")

    payload = np.moveaxis(data, -1, 0)                    # (c, z, y, x)
    if is_img:
        hdr_path, img_path = _img_pair(path)
        gz = ".gz" if lower.endswith(".gz") else ""
        hdr_path = os.path.splitext(
            path[:-3] if gz else path)[0] + ".hdr" + gz
        with _open(hdr_path, "wb") as f:
            f.write(bytes(hdr))
            f.write(b"\x00" * 4)
        with _open(img_path, "wb") as f:
            f.write(payload.tobytes())
        return
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)                              # extension flag
        f.write(payload.tobytes())
