"""SIFT3D descriptors: icosahedral gradient histograms of each keypoint's
rotated window.

A frozen copy of the port's ``features/descriptor.py`` with the plain
PyTorch version of kernel 1 (``ops/cuda_window.py``'s
``descrip_window_plain``) in place of the CUDA kernel; the original is
sift3d/sift.c:1732-1928, 2207-2243.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import (BARY_EPS, DESC_NUM_TOTAL_HIST, DESC_NUMEL,
                     DESC_RAD_FCTR, DESC_SIG_FCTR, F64, NHIST_PER_DIM,
                     TRUNC_THRESH)
from .detect import kp_levels
from .geometry import icos_hist_bin, vertex_weights
from .keypoints import Keypoints, valid_rows
from .windows import (batch_view, gather_windows, window_extent,
                      window_gradients, window_starts)

_DBL_EPSILON = 2.220446049250313e-16
# Window voxels per chunk of the plain version (bounds its temporaries:
# about 0.5 KB per voxel).
_CHUNK_VOXELS = 1 << 22


def geometry_constants(units, sigma: float, rad: float) -> dict:
    """fp32 constants shared bit for bit by the kernel and the plain
    version (rounded as the JAX package rounds them)."""
    rad32 = np.float32(rad)
    sig32 = np.float32(sigma)
    half_width = rad32 / np.float32(math.sqrt(2))
    bin_fctr = np.float32(1.0) / (np.float32(2.0) * half_width /
                                  np.float32(NHIST_PER_DIM))
    u = [np.float32(x) for x in units]
    return dict(ux=float(u[0]), uy=float(u[1]), uz=float(u[2]),
                inv_ux=float(np.float32(1.0) / u[0]),
                inv_uy=float(np.float32(1.0) / u[1]),
                inv_uz=float(np.float32(1.0) / u[2]),
                rad2=float(rad32 * rad32), sig2=float(sig32 * sig32),
                half_width=float(half_width), bin_fctr=float(bin_fctr),
                bary_eps=float(np.float32(BARY_EPS)))


def _grid_frame(starts, extents, centers, R, g):
    """The per-voxel displacement frame of a chunk of rows over a voxel
    grid starting at ``starts`` (C, 3) with ``extents`` voxels an axis:
    returns (sq (C, ez, ey, ex), (vbx, vby, vbz), in_sphere)."""
    dev = centers.device
    zg, yg, xg = ((starts[:, a, None] +
                   torch.arange(extents[a], device=dev)).float()
                  for a in range(3))
    vx = ((xg - centers[:, 2, None]) * g["ux"])[:, None, None, :]
    vy = ((yg - centers[:, 1, None]) * g["uy"])[:, None, :, None]
    vz = ((zg - centers[:, 0, None]) * g["uz"])[:, :, None, None]
    sq = vx * vx + vy * vy + vz * vz
    in_sphere = sq <= g["rad2"]

    def rt(i):
        # (R^T v)_i = R[0, i] vx + R[1, i] vy + R[2, i] vz
        c = [R[:, j, i, None, None, None] for j in range(3)]
        return c[0] * vx + c[1] * vy + c[2] * vz
    vb = tuple((rt(i) + g["half_width"]) * g["bin_fctr"] for i in range(3))
    return sq, vb, in_sphere


def _window_frame(shape, centers, R, radii, cores, g):
    """Window starts and the per-voxel displacement frame of a chunk of
    rows of a (nz, ny, nx) level: returns (starts, sq (C, cz, cy, cx),
    (vbx, vby, vbz), in_sphere)."""
    starts = window_starts(shape, torch.floor(centers).long(), radii, cores)
    return (starts,) + _grid_frame(starts, cores, centers, R, g)


def voxel_terms(win, sq, vb, keep, R, units, g):
    """Per-voxel terms of a chunk of C rows over a grid of V voxels:
    rotated weighted gradients (C, V, 3), their face, barycentrics and
    ``ok`` from ``icos_hist_bin``, and the geometry mask (C, V) of the
    voxels of ``keep`` inside the rotated bin cube. ``win`` (C, ez+2,
    ey+2, ex+2) holds the level around the grid; ``sq`` and ``vb`` are
    ``_grid_frame``'s."""
    C = win.shape[0]
    V = sq[0].numel()
    nh = float(NHIST_PER_DIM)
    inside = keep
    for v in vb:
        inside = inside & (v >= 0) & (v < nh)
    gx, gy, gz = window_gradients(win, units)
    weight = torch.exp(-0.5 * sq / g["sig2"])
    gx = gx * weight; gy = gy * weight; gz = gz * weight
    Rc = [[R[:, j, i, None, None, None] for j in range(3)] for i in range(3)]
    grad_rot = torch.stack(
        [Rc[i][0] * gx + Rc[i][1] * gy + Rc[i][2] * gz for i in range(3)],
        dim=-1).reshape(C, V, 3)
    face, bary, ok = icos_hist_bin(grad_rot)
    return grad_rot, face, bary, ok, inside.reshape(C, V)


def _chunk_terms(level, vol, centers, R, radii, cores, units, g):
    """Per-voxel terms of a chunk of C rows: bin coordinates (vbx, vby,
    vbz) and ``voxel_terms`` over the voxels in the sphere."""
    starts, sq, vb, in_sphere = _window_frame(
        level.shape[1:], centers, R, radii, cores, g)
    win = gather_windows(level, vol, starts, cores)
    return (vb,) + voxel_terms(win, sq, vb, in_sphere, R, units, g)


def histograms(vb, grad_rot, face, bary, ok, geom) -> torch.Tensor:
    """Raw histograms (C, 768) from a chunk's ``_chunk_terms``: each
    voxel's magnitude into its face's three vertices, spread trilinearly
    over the 4^3 spatial bins (SIFT3D_desc_acc_interp, sift.c:1732-1755)."""
    C, V = geom.shape
    mag = torch.sqrt(torch.sum(grad_rot * grad_rot, -1))
    Gmat = vertex_weights(face, bary) * (mag * (geom & ok))[..., None]
    b = torch.arange(NHIST_PER_DIM, device=geom.device)

    def axis_w(vb):
        vb = vb.reshape(C, V)
        flo = torch.floor(vb)
        fr = (vb - flo)[..., None]
        flo = flo.long()[..., None]
        return ((flo == b) * (1.0 - fr) + ((flo + 1) == b) * fr).float()
    wx, wy, wz = (axis_w(v) for v in vb)
    S = (wz[..., :, None, None] * wy[..., None, :, None] *
         wx[..., None, None, :]).reshape(C, V, DESC_NUM_TOTAL_HIST)
    hist = torch.bmm(S.transpose(1, 2), Gmat)          # (C, 64, 12)
    return hist.reshape(C, DESC_NUMEL)


def descrip_window_plain(level, centers, R, count: int, radii, cores,
                         units, sigma: float, rad: float,
                         vol=None) -> torch.Tensor:
    """Raw (K, 768) histograms, chunked over keypoints; rows >= count are
    zero (kernel 1's plain version)."""
    K = centers.shape[0]
    level, vol = batch_view(level, K, vol)
    out = torch.zeros((K, DESC_NUMEL), dtype=torch.float32,
                      device=level.device)
    n = min(int(count), K)
    g = geometry_constants(units, sigma, rad)
    chunk = max(1, _CHUNK_VOXELS // (cores[0] * cores[1] * cores[2]))
    centers = centers.float()
    R = R.float()
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        out[k0:k1] = histograms(*_chunk_terms(
            level, vol[k0:k1], centers[k0:k1], R[k0:k1], radii, cores,
            units, g))
    return out


@dataclasses.dataclass
class Descriptors:
    """Descriptor set (reference SIFT3D_Descriptor, imtypes.h:291-296).
    Coordinates are in base-octave (image) space; rows >= count are
    padding. A set of a batch of volumes has a leading B axis on every
    field and a (B,) count tensor."""
    xyz: torch.Tensor   # (K, 3) f64
    sd: torch.Tensor    # (K,) f64
    vec: torch.Tensor   # (K, 768) f32
    count: int

    @property
    def capacity(self) -> int:
        return self.vec.shape[-2]

    def valid_mask(self) -> torch.Tensor:
        return valid_rows(self.capacity, self.count, self.vec.device)

def postprocess(raw: torch.Tensor) -> torch.Tensor:
    """normalize -> truncate -> normalize (sift.c:1794-1821, 1909-1918)."""
    def normalize(v):
        norm = torch.sqrt(torch.sum(v.to(F64) ** 2, -1, keepdim=True)) \
            + _DBL_EPSILON
        return v * (1.0 / norm).float()
    v = normalize(raw)
    v = torch.clamp(v, max=TRUNC_THRESH)
    return normalize(v)


def level_geometry(sd: float, units, shape):
    """(sigma, rad, radii (z, y, x), cores (z, y, x)) of a level's
    descriptor windows (extract_level, sift.c:1845-1846)."""
    nz, ny, nx = shape
    sigma = np.float32(sd) * np.float32(DESC_SIG_FCTR)
    rad = np.float32(DESC_RAD_FCTR) * sigma
    Rx = int(math.ceil(float(rad) / units[0]))
    Ry = int(math.ceil(float(rad) / units[1]))
    Rz = int(math.ceil(float(rad) / units[2]))
    cores = (window_extent(Rz, nz, False), window_extent(Ry, ny, False),
             window_extent(Rx, nx, False))
    return float(sigma), float(rad), (Rz, Ry, Rx), cores


def extract_level(level: torch.Tensor, centers_zyx: torch.Tensor,
                  R: torch.Tensor, sd: float, units,
                  count: int | None = None,
                  vol: torch.Tensor | None = None) -> torch.Tensor:
    """Descriptors (K, 768) for all keypoints of one level; centers_zyx
    float (K, 3). Rows >= count (default K) are postprocessed zeros.
    ``level`` is (nz, ny, nx), or (B, nz, ny, nx) with the volume index
    ``vol`` (K,) of each row."""
    sigma, rad, radii, cores = level_geometry(sd, units, level.shape[-3:])
    if count is None:
        count = centers_zyx.shape[0]
    raw = descrip_window_plain(level, centers_zyx, R, count, radii, cores, units,
                         sigma, rad, vol=vol)
    return postprocess(raw)


def level_buckets(kp: Keypoints, plan):
    """Yield ((o, s), rows) for every non-empty level bucket of ``kp``'s
    valid rows, rows in keypoint order (one host sync for all buckets)."""
    levels = kp_levels(plan)
    per_octave = len(levels) // plan.num_octaves
    n = kp.count
    o = kp.o[:n].long()
    s = kp.s[:n].long() - (plan.first_level + 1)
    on_level = (o >= 0) & (o < plan.num_octaves) & (s >= 0) & \
        (s < per_octave)
    # Index into ``levels``; rows on no keypoint level go to a last bucket.
    lid = torch.where(on_level, o * per_octave + s, len(levels))
    order = torch.argsort(lid, stable=True)
    sizes = torch.bincount(lid, minlength=len(levels) + 1).tolist()
    start = 0
    for lv, size in zip(levels, sizes):
        if size:
            yield lv, order[start:start + size]
        start += size


def extract_descriptors(gpyr: dict, kp: Keypoints, plan,
                        vol: torch.Tensor | None = None) -> Descriptors:
    """Descriptors from the detection pyramid (SIFT3D_extract_descriptors,
    sift.c:2025-2046). Keypoint rows keep their order. With ``vol``, the
    (n,) volume index of each row, the ``gpyr`` levels are (B, nz, ny, nx)
    and each level bucket of all the volumes is one kernel launch."""
    vec = torch.zeros((kp.capacity, DESC_NUMEL), dtype=torch.float32,
                      device=kp.x.device)
    for (o, s), rows in level_buckets(kp, plan):
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        vec[rows] = extract_level(gpyr[(o, s)], centers, kp.R[rows],
                                  plan.gpyr_level(o, s).scale,
                                  plan.octave_units(o),
                                  vol=None if vol is None else vol[rows])
    factor = torch.exp2(kp.o.to(F64))
    xyz = torch.stack([kp.x * factor, kp.y * factor, kp.z * factor], -1)
    return Descriptors(xyz=xyz, sd=kp.sd, vec=vec, count=kp.count)
