"""Clamped sphere-window gathers shared by orientation and descriptors.

Every keypoint of a pyramid level shares the same window radius, so the
reference's per-keypoint sphere loops (IM_LOOP_SPHERE_START, sift.c:96-119)
become batched gathers of a fixed-size box. The box is clamped to the
level extent: a voxel can only contribute if it lies in [1, n-2], so the
core never exceeds n-2 voxels per dimension (``sift3d_tpu/features/
windows.py`` has the same rules).
"""

from __future__ import annotations

import numpy as np
import torch


def window_gradients(win: torch.Tensor, units):
    """Unit-corrected central differences over a window's core:
    0.5 * (I[+1] - I[-1]) / u per axis (IM_GET_GRAD_ISO, reference
    immacros.h:150-155). ``win`` is (..., cz+2, cy+2, cx+2) in z, y, x
    order; returns (gx, gy, gz), each (..., cz, cy, cx)."""
    inv = [float(np.float32(1.0) / np.float32(u)) for u in units]
    gx = 0.5 * (win[..., 1:-1, 1:-1, 2:] - win[..., 1:-1, 1:-1, :-2]) * inv[0]
    gy = 0.5 * (win[..., 1:-1, 2:, 1:-1] - win[..., 1:-1, :-2, 1:-1]) * inv[1]
    gz = 0.5 * (win[..., 2:, 1:-1, 1:-1] - win[..., :-2, 1:-1, 1:-1]) * inv[2]
    return gx, gy, gz


def window_extent(R: int, n: int, center_integral: bool) -> int:
    """Core extent (excluding the +-1 gradient halo) along one axis."""
    span = 2 * R + 1 if center_integral else 2 * R + 2
    return max(min(span, n - 2), 1)


def window_starts(shape, base_zyx: torch.Tensor, radii, cores) -> torch.Tensor:
    """(K, 3) clamped core starts (z, y, x) for integer base coords
    (K, 3): clip(base - R, 1, n - 1 - core) per axis."""
    starts = []
    for a in range(3):
        starts.append(torch.clamp(base_zyx[:, a].long() - radii[a], 1,
                                  shape[a] - 1 - cores[a]))
    return torch.stack(starts, dim=-1)


def batch_view(level: torch.Tensor, n_rows: int, vol=None):
    """A (B, nz, ny, nx) view of ``level`` and the (n_rows,) long volume
    index of each row. A (nz, ny, nx) level is a batch of one, whose rows
    all read volume 0."""
    if level.ndim == 3:
        level = level[None]
    if vol is None:
        return level, torch.zeros(n_rows, dtype=torch.long,
                                  device=level.device)
    return level, vol.to(device=level.device, dtype=torch.long)


def gather_windows(level: torch.Tensor, vol: torch.Tensor,
                   starts: torch.Tensor, cores):
    """(K, cz+2, cy+2, cx+2) core windows plus a 1-voxel gradient halo,
    gathered at core starts (K, 3) from volume ``vol[k]`` of a
    (B, nz, ny, nx) level."""
    cz, cy, cx = cores
    dev = level.device
    iz = starts[:, 0, None] - 1 + torch.arange(cz + 2, device=dev)
    iy = starts[:, 1, None] - 1 + torch.arange(cy + 2, device=dev)
    ix = starts[:, 2, None] - 1 + torch.arange(cx + 2, device=dev)
    return level[vol[:, None, None, None], iz[:, :, None, None],
                 iy[:, None, :, None], ix[:, None, None, :]]


def window_union(shape, vol: torch.Tensor, starts: torch.Tensor,
                 cores, covered: np.ndarray | None = None) -> int:
    """Voxels of a (B, nz, ny, nx) level that the union of the rows'
    windows (core plus gradient halo) covers, counted per volume on the
    host: windows of nearby keypoints overlap, and a kernel reads each
    voxel of the union at least once. With ``covered`` (``union_mask``),
    the windows are marked in it and only the voxels no earlier call
    marked are counted."""
    if covered is None:
        covered = np.zeros(tuple(shape), bool)
    before = int(covered.sum())
    cz, cy, cx = cores
    for b, (z, y, x) in zip(vol.tolist(), starts.tolist()):
        covered[b, z - 1:z + cz + 1, y - 1:y + cy + 1, x - 1:x + cx + 1] = True
    return int(covered.sum()) - before
