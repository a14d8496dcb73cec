"""Typed IO errors mirroring the reference's error codes
(reference imutil/imutil.h:20-27)."""


class SIFT3DIOError(Exception):
    """Base class for image IO errors."""


class FileDoesNotExistError(SIFT3DIOError):
    """SIFT3D_FILE_DOES_NOT_EXIST."""


class UnsupportedFileTypeError(SIFT3DIOError):
    """SIFT3D_UNSUPPORTED_FILE_TYPE."""


class WrapperNotCompiledError(SIFT3DIOError):
    """SIFT3D_WRAPPER_NOT_COMPILED - the format backend is unavailable."""


class UnevenSpacingError(SIFT3DIOError):
    """SIFT3D_UNEVEN_SPACING - DICOM slices unevenly spaced."""


class InconsistentAxesError(SIFT3DIOError):
    """SIFT3D_INCONSISTENT_AXES - DICOM slice axes disagree."""


class DuplicateSlicesError(SIFT3DIOError):
    """SIFT3D_DUPLICATE_SLICES - repeated DICOM slice coordinates."""
