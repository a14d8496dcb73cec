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

All keypoints of a level share one window box, so the windows of a chunk
of keypoints are one batched gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import MAX_EIG_RATIO, ORI_GRAD_THRESH, ORI_RAD_FCTR, ORI_SIG_FCTR
from ..dtypes import F64
from ..ops.eig import eigh3x3
from .windows import gather_windows, window_extent, window_gradients, window_starts

# Voxels gathered per chunk of keypoints (bounds the temporaries).
_CHUNK_VOXELS = 1 << 22


def window_radii(rad: float, units) -> tuple[int, int, int]:
    """Per-dimension voxel half-extents (x, y, z) of the sphere's box."""
    return tuple(int(math.ceil(np.float32(rad) / np.float32(u)))
                 for u in units)


def _window_terms(level, zyx, radii, cores, units, rad, sigma):
    """Masked structure-tensor sums for a chunk of keypoints.

    zyx (C, 3) integer centers; radii and cores in (z, y, x) order.
    Returns (A6 (C, 6) float64 upper-triangle terms, vd (C, 3) float32).
    """
    ux, uy, uz = (float(np.float32(u)) for u in units)
    starts = window_starts(level.shape, zyx, radii, cores)
    win = gather_windows(level, starts, cores)
    cz, cy, cx = cores
    dev = level.device
    zyx = zyx.long()
    iz = (starts[:, 0, None] + torch.arange(cz, device=dev))[:, :, None, None]
    iy = (starts[:, 1, None] + torch.arange(cy, device=dev))[:, None, :, None]
    ix = (starts[:, 2, None] + torch.arange(cx, device=dev))[:, None, None, :]
    z0 = zyx[:, 0, None, None, None]
    y0 = zyx[:, 1, None, None, None]
    x0 = zyx[:, 2, None, None, None]
    Rz, Ry, Rx = radii
    in_box = ((ix >= x0 - Rx) & (ix <= x0 + Rx) & (iy >= y0 - Ry) &
              (iy <= y0 + Ry) & (iz >= z0 - Rz) & (iz <= z0 + Rz))

    ddx = (ix - x0).float() * ux
    ddy = (iy - y0).float() * uy
    ddz = (iz - z0).float() * uz
    sq_dist = ddx * ddx + ddy * ddy + ddz * ddz
    rad32 = np.float32(rad)
    mask = in_box & (sq_dist <= float(rad32 * rad32))

    gx, gy, gz = window_gradients(win, units)
    sig32 = np.float32(sigma)
    w = torch.exp(-0.5 * sq_dist / float(sig32 * sig32))
    w = torch.where(mask, w, torch.zeros_like(w))

    gx64, gy64, gz64, w64 = (t.to(F64) for t in (gx, gy, gz, w))
    dims = (1, 2, 3)
    A6 = torch.stack([
        torch.sum(gx64 * gx64 * w64, dims), torch.sum(gx64 * gy64 * w64, dims),
        torch.sum(gx64 * gz64 * w64, dims), torch.sum(gy64 * gy64 * w64, dims),
        torch.sum(gy64 * gz64 * w64, dims), torch.sum(gz64 * gz64 * w64, dims)],
        dim=-1)
    vd = torch.stack([torch.sum(gx * w, dims), torch.sum(gy * w, dims),
                      torch.sum(gz * w, dims)], dim=-1)
    return A6, vd


def assign_orientations_level(level: torch.Tensor, zyx: torch.Tensor,
                              sd: float, units, corner_thresh: float):
    """Assign orientations to all keypoints of one level.

    Args:
      level: (nz, ny, nx) Gaussian pyramid level.
      zyx: (K, 3) integer keypoint voxel coords.
      sd: the level's absolute scale (shared by every keypoint on it).
      units: level units (ux, uy, uz).
      corner_thresh: rejection threshold on the corner score.

    Returns:
      R: (K, 3, 3) float32 rotation matrices; valid: (K,) bool.
    """
    nz, ny, nx = level.shape
    sigma = ORI_SIG_FCTR * sd
    rad = sigma * ORI_RAD_FCTR
    Rx, Ry, Rz = window_radii(rad, units)
    radii = (Rz, Ry, Rx)
    cores = (window_extent(Rz, nz, True), window_extent(Ry, ny, True),
             window_extent(Rx, nx, True))
    K = zyx.shape[0]
    win_vox = (cores[0] + 2) * (cores[1] + 2) * (cores[2] + 2)
    chunk = max(1, _CHUNK_VOXELS // win_vox)
    A6s, vds = [], []
    for k0 in range(0, K, chunk):
        A6, vd = _window_terms(level, zyx[k0:k0 + chunk], radii, cores,
                               units, rad, sigma)
        A6s.append(A6)
        vds.append(vd)
    if K == 0:
        A6 = torch.zeros((0, 6), dtype=F64, device=level.device)
        vd = torch.zeros((0, 3), dtype=torch.float32, device=level.device)
    else:
        A6, vd = torch.cat(A6s), torch.cat(vds)
    return orientations_from_tensor(A6, vd, corner_thresh)


def orientations_from_tensor(A6: torch.Tensor, vd: torch.Tensor,
                             corner_thresh: float):
    """Eigendecomposition + sign fixing + corner test (sift.c:1430-1492).

    Returns (R (K, 3, 3) float32, valid (K,) bool).
    """
    axx, axy, axz, ayy, ayz, azz = A6.unbind(-1)
    A = torch.stack([
        torch.stack([axx, axy, axz], -1),
        torch.stack([axy, ayy, ayz], -1),
        torch.stack([axz, ayz, azz], -1)], -2)
    lam, Q = eigh3x3(A)             # ascending eigenvalues

    grad_ok = (vd[:, 0] * vd[:, 0] + vd[:, 1] * vd[:, 1] +
               vd[:, 2] * vd[:, 2]) >= ORI_GRAD_THRESH

    # Stability: reject if |lam[i] / lam[i+1]| > 0.90. NaN comparisons are
    # false, matching the C semantics of fabs(nan) > thresh.
    r0 = torch.abs(lam[:, 0] / lam[:, 1]) > MAX_EIG_RATIO
    r1 = torch.abs(lam[:, 1] / lam[:, 2]) > MAX_EIG_RATIO
    ratio_reject = r0 | r1

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

    valid = grad_ok & ~ratio_reject & (corner_score >= corner_thresh)
    return R, valid
