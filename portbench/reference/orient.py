"""Keypoint orientation: the structure tensor of each keypoint's window,
its eigenvectors and the rejection tests.

A frozen copy of the port's ``features/orientation.py`` with the plain
PyTorch version of kernel 3 (``ops/cuda_orient.py``'s
``orient_terms_plain``) in place of the CUDA kernel; the original is
sift3d/sift.c:1354-1492.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import (F64, MAX_EIG_RATIO, ORI_GRAD_THRESH, ORI_RAD_FCTR,
                     ORI_SIG_FCTR)
from .eig import eigh3x3
from .windows import (batch_view, gather_windows, window_extent,
                      window_gradients, window_starts)

# Window voxels per chunk of the plain version (bounds its temporaries).
_CHUNK_VOXELS = 1 << 22


def _constants(units, sigma: float, rad: float) -> dict:
    """fp32 constants shared bit for bit by the kernel and the plain
    version (rounded as the JAX package rounds them)."""
    u = [np.float32(x) for x in units]
    rad32, sig32 = np.float32(rad), np.float32(sigma)
    sig2 = sig32 * sig32
    return dict(ux=float(u[0]), uy=float(u[1]), uz=float(u[2]),
                inv_ux=float(np.float32(1.0) / u[0]),
                inv_uy=float(np.float32(1.0) / u[1]),
                inv_uz=float(np.float32(1.0) / u[2]),
                rad2=float(rad32 * rad32), sig2=float(sig2),
                w_scale=float(np.float32(1.0) / sig2))


def _sq(dz, dy, dx, g):
    """|v|^2 of integer offsets (broadcastable long tensors), in fp32."""
    vx = dx.float() * g["ux"]
    vy = dy.float() * g["uy"]
    vz = dz.float() * g["uz"]
    return vx * vx + vy * vy + vz * vz


def _weight(sq, g):
    return torch.exp(-0.5 * sq / g["sig2"])


def _offsets(starts, zyx, extents):
    """(dz, dy, dx): the integer offsets from each row's centre ``zyx``
    (C, 3) of a voxel grid starting at ``starts`` (C, 3) with ``extents``
    voxels an axis, broadcastable to (C, ez, ey, ex)."""
    d = [(starts[:, a, None] + torch.arange(extents[a], device=zyx.device))
         - zyx[:, a, None] for a in range(3)]
    return (d[0][:, :, None, None], d[1][:, None, :, None],
            d[2][:, None, None, :])


def _in_box(offsets, radii):
    """The mask |d| <= R per axis of ``_offsets``."""
    return ((offsets[2].abs() <= radii[2]) & (offsets[1].abs() <= radii[1]) &
            (offsets[0].abs() <= radii[0]))


def window_sums(win, offsets, radii, units, g, keep=None):
    """The nine window sums of a chunk of C rows: (A6 (C, 6) float64,
    vd (C, 3) float32). ``win`` (C, ez+2, ey+2, ex+2) holds the level
    around a grid of voxels, ``offsets`` (``_offsets``) their offsets from
    each row's centre; a voxel counts inside the box and the sphere, and
    where ``keep`` (broadcastable to (C, ez, ey, ex)) is True."""
    sq = _sq(*offsets, g)
    mask = _in_box(offsets, radii) & (sq <= g["rad2"])
    if keep is not None:
        mask = mask & keep
    gx, gy, gz = window_gradients(win, units)
    w = _weight(sq, g)
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


def _plain_chunk(level, vol, zyx, radii, cores, units, g):
    starts = window_starts(level.shape[1:], zyx, radii, cores)
    return window_sums(gather_windows(level, vol, starts, cores),
                       _offsets(starts, zyx, cores), radii, units, g)


def orient_terms_plain(level, zyx, count: int, radii, cores, units,
                       sigma: float, rad: float, vol=None):
    """The plain PyTorch version: (A6 (K, 6) float64, vd (K, 3) float32),
    chunked over rows; rows >= count are zero."""
    K = zyx.shape[0]
    level, vol = batch_view(level, K, vol)
    A6 = torch.zeros((K, 6), dtype=F64, device=level.device)
    vd = torch.zeros((K, 3), dtype=torch.float32, device=level.device)
    n = min(int(count), K)
    g = _constants(units, sigma, rad)
    zyx = zyx.to(device=level.device, dtype=torch.long)
    chunk = max(1, _CHUNK_VOXELS // ((cores[0] + 2) * (cores[1] + 2) *
                                     (cores[2] + 2)))
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        A6[k0:k1], vd[k0:k1] = _plain_chunk(level, vol[k0:k1], zyx[k0:k1],
                                            radii, cores, units, g)
    return A6, vd


def orient_terms_levels_plain(rows, levels):
    """``orient_terms_levels``' plain version: ``orient_terms_plain`` on
    each level's rows, concatenated."""
    A6, vd, r0 = [], [], 0
    for level, n, count, *geom in levels:
        r = rows[r0:r0 + n]
        a, v = orient_terms_plain(level, r[:, 1:], count, *geom,
                                  vol=r[:, 0])
        A6.append(a)
        vd.append(v)
        r0 += n
    dev = rows.device if not levels else levels[0][0].device
    if not A6:
        return (torch.zeros((0, 6), dtype=F64, device=dev),
                torch.zeros((0, 3), dtype=torch.float32, device=dev))
    return torch.cat(A6), torch.cat(vd)


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
    A6, vd = orient_terms_levels_plain(rows, args)
    R, valid = orientations_from_tensor(A6, vd, corner_thresh)
    return rows, R, valid


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
