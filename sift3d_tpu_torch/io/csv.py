"""CSV serialization, byte-compatible with the reference.

write_Mat_rm (reference imutil.c:1343-1421) prints each element with C
"%f" (6 decimals), comma-delimited, newline-terminated rows, gzip when the
path ends in .gz. Keypoint rows are [x y z o s R00..R22] (write_Keypoint_store,
sift.c:3130-3202); descriptor rows are [x y z el0..el767] float
(SIFT3D_Descriptor_store_to_Mat_rm, sift.c:2664-2717); an affine transform
is its 3x4 matrix (write_Affine, imutil.c:2845-2858).
"""

from __future__ import annotations

import gzip

import numpy as np


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def write_mat(path: str, mat: np.ndarray, fmt: str = "%f") -> None:
    """C-printf-compatible CSV writer (write_Mat_rm, imutil.c:1343-1421)."""
    mat = np.atleast_2d(np.asarray(mat))
    with _open(path, "wt") as f:
        for row in mat:
            f.write(",".join(fmt % v for v in row))
            f.write("\n")


def read_mat(path: str) -> np.ndarray:
    with _open(path, "rt") as f:
        rows = [[float(v) for v in line.strip().rstrip(",").split(",")]
                for line in f if line.strip()]
    return np.asarray(rows, np.float64)


def write_keypoints(path: str, kp_rows: np.ndarray) -> None:
    """kp_rows: (N, 14) [x y z o sd R00..R22] (Keypoints.to_numpy format).

    The reference stores column 4 as the *scale* coordinate sd
    (write_Keypoint_store, sift.c:3176).
    """
    write_mat(path, kp_rows)


def read_keypoints(path: str) -> np.ndarray:
    return read_mat(path)


def write_descriptors(path: str, desc_rows: np.ndarray) -> None:
    """desc_rows: (N, 771) [x y z el0..el767] (Descriptors.to_numpy)."""
    write_mat(path, desc_rows)


def read_descriptors(path: str) -> np.ndarray:
    """Parse descriptors CSV (SIFT3D_Descriptor_store_from_Mat_rm,
    sift.c:2721-2768)."""
    rows = read_mat(path)
    if rows.shape[1] != 771:
        raise ValueError(
            f"descriptor CSV must have 771 columns, got {rows.shape[1]}")
    return rows


def write_affine(path: str, A: np.ndarray) -> None:
    """Write a 3x4 affine (write_Affine, imutil.c:2845-2858)."""
    A = np.asarray(A)
    if A.shape != (3, 4):
        raise ValueError(f"affine must be 3x4, got {A.shape}")
    write_mat(path, A)


def write_matches(path: str, src_xyz: np.ndarray, ref_xyz: np.ndarray
                  ) -> None:
    """Concatenated 6-column match CSV [src_xyz | ref_xyz]
    (regSift3D, cli/regSift3D.c:333-358)."""
    write_mat(path, np.concatenate([src_xyz, ref_xyz], axis=1))


def write_tps(path: str, params: np.ndarray, ctrl: np.ndarray) -> None:
    """Write a thin-plate-spline transform as an (n+4, n+4) CSV.

    The reference never defined a TPS serialization (write_Tps is
    unimplemented, imutil.c:2861-2868), so this format is ours: row 0 is
    [n_ctrl, 0, ...], rows 1-3 are the (3, n_ctrl+4) params matrix, and
    the remaining n_ctrl rows are the control points padded with zeros.
    Written at full precision (%.17g): unlike the affine CSV, whose %f
    matches reference byte-compatibility, spline weights are tiny and
    get amplified by U(r^2) = r^2 log r^2 - 6 fixed decimals would cost
    millimeters after a round-trip.
    """
    params = np.asarray(params)
    ctrl = np.asarray(ctrl)
    n = ctrl.shape[0]
    assert params.shape == (3, n + 4), (params.shape, n)
    out = np.zeros((1 + 3 + n, n + 4))
    out[0, 0] = n
    out[1:4] = params
    out[4:, :3] = ctrl
    write_mat(path, out, fmt="%.17g")


def read_tps(path: str):
    """Inverse of :func:`write_tps`; returns (params (3, n+4), ctrl)."""
    m = read_mat(path)
    n = int(round(m[0, 0]))
    return m[1:4, :n + 4], m[4:4 + n, :3]
