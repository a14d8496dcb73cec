"""File-format dispatch (im_read / im_write, reference imutil.c:1166-1297).

Extension / directory sniffing mirrors im_get_format (imutil.c:1166-1193):
directories and .dcm files are DICOM; .nii, .nii.gz, .img and .img.gz
(ANALYZE / NIFTI-1 pair) are NIFTI; anything else raises
UnsupportedFileTypeError.
"""

from __future__ import annotations

import os

from . import nifti
from .errors import FileDoesNotExistError, UnsupportedFileTypeError
from .volume import Volume


def _get_format(path: str, must_exist: bool) -> str:
    if os.path.isdir(path):
        return "directory"
    lower = str(path).lower()
    if lower.endswith(".dcm"):
        return "dicom"
    if (lower.endswith(".nii") or lower.endswith(".nii.gz") or
            lower.endswith(".img") or lower.endswith(".img.gz")):
        # .img = ANALYZE / NIFTI-1 pair, routed through the NIFTI codec
        # like the reference (imutil.c:1181-1185, ext_analyze).
        return "nifti"
    if must_exist and not os.path.exists(path):
        raise FileDoesNotExistError(path)
    raise UnsupportedFileTypeError(path)


def im_read(path: str) -> Volume:
    """Read a volume from NIFTI or DICOM (imutil.c:1215-1249)."""
    if not os.path.exists(path):
        raise FileDoesNotExistError(path)
    fmt = _get_format(path, must_exist=True)
    if fmt == "nifti":
        return nifti.read_nii(path)
    from . import dicom
    if fmt == "dicom":
        return dicom.read_dcm(path)
    return dicom.read_dcm_dir(path)


def im_write(path: str, vol: Volume) -> None:
    """Write a volume to NIFTI or DICOM (imutil.c:1263-1297)."""
    fmt = _get_format(path, must_exist=False)
    if fmt == "nifti":
        return nifti.write_nii(path, vol)
    from . import dicom
    if fmt == "dicom":
        return dicom.write_dcm(path, vol)
    return dicom.write_dcm_dir(path, vol)
