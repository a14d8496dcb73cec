"""Spatially-sharded orientation and descriptor windows.

The port of ``sift3d_tpu/parallel/shard_windows.py``. Orientation windows
(radius 3 * 1.5 * sd mm) and descriptor windows (radius 2 * 7.07 * sd mm)
span most of a volume at octave 0, so a halo as wide as the window would
be wider than the slab. Both stages are *sums over window voxels* instead:
the 3x3 structure tensor and window gradient (assign_eig_ori, reference
sift3d/sift.c:1354-1514) and the 64 x 12 descriptor histogram
(extract_descrip, sift.c:1834-1928). Each rank sums over the window
voxels of its own slab of the sharded axis (with a 1-voxel gradient halo,
``shard_halo``), and the partial sums meet in an ``all_reduce`` over
"space": (K, 6) + (K, 3) for orientation, (K, 768) for descriptors. No
window voxel is held by two ranks; the keypoints are replicated instead.

A window's core is clamped on the *global* level (``window_starts``). On
its rank, a row walks the planes of its core that lie in the slab: a fixed
run of min(S, core) planes placed inside the slab so that it covers them,
the planes outside the core masked. The per-voxel arithmetic is the plain
versions' of kernels 3 and 1 (``ops/cuda_orient.window_sums``,
``ops/cuda_window.voxel_terms`` / ``histograms``), in plain torch as the
JAX module is plain JAX, over chunks of rows.
"""

from __future__ import annotations

import torch

from ..features.descriptor import level_geometry as desc_geometry
from ..features.descriptor import postprocess
from ..features.orientation import level_geometry as orient_geometry
from ..features.orientation import orientations_from_tensor
from ..features.windows import gather_windows, window_starts
from ..ops import cuda_orient, cuda_window
from .mesh import Mesh, psum
from .shard_conv import DIMS, shard_halo

# Window voxels per chunk of rows (bounds the temporaries, about 0.5 KB a
# voxel for descriptors).
CHUNK_VOXELS = 1 << 22


def _slab_grid(starts, cores, sd: int, S: int, a0: int):
    """The part of each row's core (global ``starts`` (C, 3), ``cores``)
    that this rank's slab [a0, a0 + S) of axis ``sd`` holds: the grid's
    global starts and extents (min(S, core) planes along ``sd``), its
    gather starts in the halo-extended block, and the mask of its planes
    that lie in the core."""
    L = min(S, cores[sd])
    st = starts[:, sd]
    b = torch.clamp(st, a0, a0 + S - L)
    grid = starts.clone()
    grid[:, sd] = b
    local = grid.clone()
    local[:, sd] = b - a0 + 1          # global plane g is block plane g-a0+1
    extents = list(cores)
    extents[sd] = L
    plane = b[:, None] + torch.arange(L, device=starts.device)
    in_core = (plane >= st[:, None]) & (plane < (st + cores[sd])[:, None])
    shape = [-1, 1, 1, 1]
    shape[1 + sd] = L
    return grid, extents, local, in_core.reshape(shape)


def _rows(level, pts):
    """Rank-local rows of a (B, K, ...) batch of points: the flat points,
    and the volume index of each."""
    B, K = pts.shape[:2]
    vol = torch.arange(B, device=level.device).repeat_interleave(K)
    return pts.reshape((B * K,) + pts.shape[2:]), vol


def orient_level_sharded(level: torch.Tensor, zyx: torch.Tensor,
                         sd_scale: float, units, corner_thresh: float,
                         mesh: Mesh, axis_name: str = "space",
                         shard_dim: str = "z"):
    """Orientations of one level's keypoints, the windows split over the
    ``shard_dim`` axis.

    Args:
      level: this rank's (B, nz, ny, nx) block (its slab of ``shard_dim``).
      zyx: (B, K, 3) integer keypoint voxel coords, the same on every rank
        of the axis.
    Returns (R (B, K, 3, 3) float32, valid (B, K) bool), the same on every
    rank of the axis.
    """
    B, K = zyx.shape[:2]
    sd = DIMS[shard_dim]
    S = level.shape[1 + sd]
    n3 = list(level.shape[1:])
    n3[sd] *= mesh.size(axis_name)
    a0 = mesh.index(axis_name) * S
    sigma, rad, radii, cores = orient_geometry(sd_scale, units, n3)
    g = cuda_orient._constants(units, sigma, rad)
    ext = shard_halo(level, 1, mesh, 1 + sd, axis_name)
    pts, vol = _rows(level, zyx.to(level.device).long())
    A6 = torch.zeros((B * K, 6), dtype=torch.float64, device=level.device)
    vd = torch.zeros((B * K, 3), dtype=torch.float32, device=level.device)
    box = [c + 2 for c in cores]
    box[sd] = min(S, cores[sd]) + 2
    chunk = max(1, CHUNK_VOXELS // (box[0] * box[1] * box[2]))
    for k0 in range(0, B * K, chunk):
        p = pts[k0:k0 + chunk]
        starts = window_starts(n3, p, radii, cores)
        grid, extents, local, in_core = _slab_grid(starts, cores, sd, S, a0)
        win = gather_windows(ext, vol[k0:k0 + chunk], local, extents)
        A6[k0:k0 + chunk], vd[k0:k0 + chunk] = cuda_orient.window_sums(
            win, cuda_orient._offsets(grid, p, extents), radii, units, g,
            keep=in_core)
    R, valid = orientations_from_tensor(psum(A6, mesh, axis_name),
                                        psum(vd, mesh, axis_name),
                                        corner_thresh)
    return R.reshape(B, K, 3, 3), valid.reshape(B, K)


def descrip_level_sharded(level: torch.Tensor, centers_zyx: torch.Tensor,
                          Rmat: torch.Tensor, sd_scale: float, units,
                          mesh: Mesh, axis_name: str = "space",
                          shard_dim: str = "z") -> torch.Tensor:
    """Descriptors of one level's keypoints, the windows split over the
    ``shard_dim`` axis.

    Args:
      level: this rank's (B, nz, ny, nx) block (its slab of ``shard_dim``).
      centers_zyx: (B, K, 3) fractional centres; Rmat: (B, K, 3, 3); both
        the same on every rank of the axis.
    Returns (B, K, 768) float32 postprocessed descriptors, the same on
    every rank of the axis.
    """
    B, K = centers_zyx.shape[:2]
    sd = DIMS[shard_dim]
    S = level.shape[1 + sd]
    n3 = list(level.shape[1:])
    n3[sd] *= mesh.size(axis_name)
    a0 = mesh.index(axis_name) * S
    sigma, rad, radii, cores = desc_geometry(sd_scale, units, n3)
    g = cuda_window.geometry_constants(units, sigma, rad)
    ext = shard_halo(level, 1, mesh, 1 + sd, axis_name)
    centers, vol = _rows(level, centers_zyx.to(level.device).float())
    R = Rmat.to(level.device).float().reshape(B * K, 3, 3)
    raw = torch.zeros((B * K, 768), dtype=torch.float32, device=level.device)
    box = list(cores)
    box[sd] = min(S, cores[sd])
    chunk = max(1, CHUNK_VOXELS // (box[0] * box[1] * box[2]))
    for k0 in range(0, B * K, chunk):
        c, r = centers[k0:k0 + chunk], R[k0:k0 + chunk]
        starts = window_starts(n3, torch.floor(c).long(), radii, cores)
        grid, extents, local, in_core = _slab_grid(starts, cores, sd, S, a0)
        sq, vb, in_sphere = cuda_window._grid_frame(grid, extents, c, r, g)
        win = gather_windows(ext, vol[k0:k0 + chunk], local, extents)
        raw[k0:k0 + chunk] = cuda_window.histograms(
            vb, *cuda_window.voxel_terms(win, sq, vb, in_sphere & in_core,
                                         r, units, g))
    return postprocess(psum(raw, mesh, axis_name)).reshape(B, K, 768)


def orient_level_z_sharded(level, zyx, sd, units, corner_thresh, mesh,
                           axis_name: str = "space"):
    """z-sharded orientation windows (the JAX package's alias)."""
    return orient_level_sharded(level, zyx, sd, units, corner_thresh, mesh,
                                axis_name, "z")


def descrip_level_z_sharded(level, centers_zyx, Rmat, sd, units, mesh,
                            axis_name: str = "space") -> torch.Tensor:
    """z-sharded descriptor windows (the JAX package's alias)."""
    return descrip_level_sharded(level, centers_zyx, Rmat, sd, units, mesh,
                                 axis_name, "z")
