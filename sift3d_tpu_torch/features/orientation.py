"""Orientation assignment via the gradient structure tensor.

Reproduces assign_orientations / assign_eig_ori (reference
sift3d/sift.c:1259-1514) on the eager window path of
``sift3d_tpu/features/orientation.py``:

- window = sphere of radius 3 * (1.5 * sd) in real-world units around the
  keypoint, clipped to [1, n-2] per dimension (IM_LOOP_SPHERE_START,
  sift.c:96-119);
- Gaussian-weighted 3x3 structure tensor (float64 sums) and window
  gradient (float32 sums) from unit-corrected central differences;
- reject if |window gradient|^2 < 1e-10 (sift.c:1426);
- eigendecompose ascending; reject if any adjacent eigenvalue ratio
  magnitude exceeds 0.90 (sift.c:1440-1444);
- two leading eigenvectors sign-fixed by positive directional derivative;
  third column = cross product; corner score = min |cos(angle to window
  gradient)|, rejected if < corner_thresh (sift.c:1446-1492).

All keypoints of a level share one window box. The nine window sums come
from ``ops/cuda_orient``: the CUDA kernel on the card, its plain PyTorch
version on the CPU, for the rows of one volume or of a batch, one level
(``orient_terms``) or every level of a detection at once
(``orient_terms_levels``, whose arguments ``levels_args`` builds).
``assign_orientations_raw`` takes the keypoints of every level bucket to
one smoothed raw image and sends them through the same single launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import MAX_EIG_RATIO, ORI_GRAD_THRESH, ORI_RAD_FCTR, ORI_SIG_FCTR
from ..dtypes import F64
from ..ops.cuda_orient import orient_terms, orient_terms_levels
from ..ops.eig import eigh3x3
from .dense import smooth_scale_raw_input
from .windows import window_extent


def window_radii(rad: float, units) -> tuple[int, int, int]:
    """Per-dimension voxel half-extents (x, y, z) of the sphere's box."""
    return tuple(int(math.ceil(np.float32(rad) / np.float32(u)))
                 for u in units)


def level_geometry(sd: float, units, shape):
    """(sigma, rad, radii (z, y, x), cores (z, y, x)) of a level's
    orientation windows (sift.c:1354-1366)."""
    nz, ny, nx = shape
    sigma = ORI_SIG_FCTR * sd
    rad = sigma * ORI_RAD_FCTR
    Rx, Ry, Rz = window_radii(rad, units)
    cores = (window_extent(Rz, nz, True), window_extent(Ry, ny, True),
             window_extent(Rx, nx, True))
    return sigma, rad, (Rz, Ry, Rx), cores


def level_terms(level: torch.Tensor, zyx: torch.Tensor, sd: float, units,
                vol: torch.Tensor | None = None):
    """Window sums (A6 (K, 6) float64, vd (K, 3) float32) of the keypoints
    of one level: ``level`` (nz, ny, nx), or (B, nz, ny, nx) with the
    volume index ``vol`` (K,) of each row."""
    sigma, rad, radii, cores = level_geometry(sd, units, level.shape[-3:])
    return orient_terms(level, zyx, zyx.shape[0], radii, cores, units,
                        sigma, rad, vol=vol)


def levels_args(levels):
    """``orient_terms_levels``' arguments for the keypoint rows of many
    levels: ``levels`` holds, per level, (level (B, nz, ny, nx), rows (n, 4)
    integer (volume, z, y, x), sd, units). Returns the rows of all levels,
    concatenated once, and the per-level argument tuples."""
    args = []
    for level, rows, sd, units in levels:
        sigma, rad, radii, cores = level_geometry(sd, units, level.shape[-3:])
        n = rows.shape[0]
        args.append((level, n, n, radii, cores, units, sigma, rad))
    return torch.cat([lv[1] for lv in levels]), args


def assign_orientations_levels(levels, corner_thresh: float):
    """Assign orientations to the keypoint rows of many levels (``levels``
    as ``levels_args`` takes them) in one kernel launch.

    Returns (rows (N, 4) concatenated, R (N, 3, 3) float32, valid (N,)
    bool).
    """
    rows, args = levels_args(levels)
    A6, vd = orient_terms_levels(rows, args)
    R, valid = orientations_from_tensor(A6, vd, corner_thresh)
    return rows, R, valid


def assign_orientations_level(level: torch.Tensor, zyx: torch.Tensor,
                              sd: float, units, corner_thresh: float,
                              vol: torch.Tensor | None = None):
    """Assign orientations to all keypoints of one level.

    Args:
      level: (nz, ny, nx) Gaussian pyramid level, or (B, nz, ny, nx) with
        ``vol``.
      zyx: (K, 3) integer keypoint voxel coords.
      sd: the level's absolute scale (shared by every keypoint on it).
      units: level units (ux, uy, uz).
      corner_thresh: rejection threshold on the corner score.
      vol: optional (K,) volume index of each row.

    Returns:
      R: (K, 3, 3) float32 rotation matrices; valid: (K,) bool.
    """
    A6, vd = level_terms(level, zyx, sd, units, vol)
    return orientations_from_tensor(A6, vd, corner_thresh)


def assign_orientations_raw(vol: torch.Tensor, kp, units, plan, params):
    """Orientations from a raw (nz, ny, nx) image and a keypoint list
    (SIFT3D_assign_orientations, reference sift.c:1534-1607).

    The image is smoothed sigma_n -> sigma0 and scaled; each keypoint goes
    to the base octave (voxel floor(zyx * 2^o), sd unchanged) and its
    structure tensor is taken on the single smoothed image with its level
    bucket's sd in the base units. Every bucket is one entry of one
    ``orient_terms_levels`` call (one kernel launch on the card), all
    sharing the smoothed image. Rejected rows, and rows on no keypoint
    level, keep R = I with confidence -1, like the reference.

    Returns (R (K, 3, 3) float32, conf (K,) float32 corner scores).
    """
    smoothed = smooth_scale_raw_input(vol, units, params)
    dev = smoothed.device
    K = kp.capacity
    R_out = torch.eye(3, dtype=torch.float32, device=dev).repeat(K, 1, 1)
    conf_out = torch.full((K,), -1.0, dtype=torch.float32, device=dev)
    levels, idx = raw_keypoint_levels(smoothed, kp, plan, units)
    if not levels:
        return R_out, conf_out
    rows, args = levels_args(levels)
    A6, vd = orient_terms_levels(rows, args)
    R, valid, conf = orientations_from_tensor(A6, vd, params.corner_thresh,
                                              return_conf=True)
    R_out[idx] = torch.where(valid[:, None, None], R, R_out[idx])
    conf_out[idx] = torch.where(valid, conf, -1.0)
    return R_out, conf_out


def raw_keypoint_levels(smoothed: torch.Tensor, kp, plan, units):
    """``assign_orientations_levels``' levels of the raw-image path: per
    non-empty (o, s) bucket of ``kp``, (the smoothed image, rows (n, 4)
    (0, floor(zyx * 2^o)), the bucket's sd, the base units), and the
    keypoint index of every row, concatenated."""
    from .descriptor import level_buckets

    levels, idx = [], []
    for (o, s), rows in level_buckets(kp, plan, "orientation"):
        zyx = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        zyx = torch.floor(zyx * float(np.float32(2.0 ** o))).long()
        vz = torch.zeros_like(zyx[:, :1])
        levels.append((smoothed, torch.cat([vz, zyx], 1),
                       plan.gpyr_level(o, s).scale, tuple(units)))
        idx.append(rows)
    return levels, (torch.cat(idx) if idx else None)


def orientation_scores(A6: torch.Tensor, vd: torch.Tensor):
    """Eigendecomposition, sign fixing and the quantities the tests read
    (sift.c:1430-1492).

    Returns (R (K, 3, 3) float32, grad_ok (K,) bool, ratio (K, 2) the
    adjacent eigenvalue ratios |lam[i] / lam[i+1]|, corner score (K,)).
    """
    axx, axy, axz, ayy, ayz, azz = A6.unbind(-1)
    A = torch.stack([
        torch.stack([axx, axy, axz], -1),
        torch.stack([axy, ayy, ayz], -1),
        torch.stack([axz, ayz, azz], -1)], -2)
    lam, Q = eigh3x3(A)             # ascending eigenvalues

    grad_ok = (vd[:, 0] * vd[:, 0] + vd[:, 1] * vd[:, 1] +
               vd[:, 2] * vd[:, 2]) >= ORI_GRAD_THRESH
    ratio = torch.abs(torch.stack([lam[:, 0] / lam[:, 1],
                                   lam[:, 1] / lam[:, 2]], -1))

    vd32 = vd.float()
    vd_norm = torch.sqrt(torch.sum(vd32 * vd32, dim=-1))

    cols, cos_abs = [], []
    for i in range(2):
        v = Q[:, :, 2 - i].float()
        d = torch.sum(vd32 * v, dim=-1)
        v_norm = torch.sqrt(torch.sum(v * v, dim=-1))
        cos_ang = d.to(F64) / (v_norm * vd_norm).to(F64)
        cos_abs.append(torch.abs(cos_ang))
        sgn = torch.where(d > 0, 1.0, -1.0).to(torch.float32)
        cols.append(v * sgn[:, None])
    corner_score = torch.minimum(cos_abs[0], cos_abs[1])
    v2 = torch.linalg.cross(cols[0], cols[1], dim=-1)
    R = torch.stack([cols[0], cols[1], v2], dim=-1)  # columns as reference
    return R, grad_ok, ratio, corner_score


def orientations_from_tensor(A6: torch.Tensor, vd: torch.Tensor,
                             corner_thresh: float, return_conf: bool = False):
    """Orientation and the rejection tests (sift.c:1426-1492): the window
    gradient, |lam[i] / lam[i+1]| > 0.90 (NaN comparisons are false,
    matching the C semantics of fabs(nan) > thresh), and the corner score.

    Returns (R (K, 3, 3) float32, valid (K,) bool), and the corner score as
    float32 with ``return_conf``.
    """
    R, grad_ok, ratio, corner_score = orientation_scores(A6, vd)
    ratio_reject = (ratio > MAX_EIG_RATIO).any(-1)
    valid = grad_ok & ~ratio_reject & (corner_score >= corner_thresh)
    if return_conf:
        return R, valid, corner_score.float()
    return R, valid
