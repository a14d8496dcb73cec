"""Orientation window: the CUDA kernel (``csrc/orient_window.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``_orient_kernel_body`` of
``sift3d_tpu/ops/pallas_orient.py``. Both versions compute, for each
keypoint row below ``count``, the Gaussian-weighted sums of the
orientation structure tensor over the row's clamped core window of one
pyramid level (see the kernel source for the per-voxel steps): six
upper-triangle terms w gi gj, summed in float64 from float64 casts of the
fp32 gradients and weights as the JAX package's eager path does
(``sift3d_tpu/features/orientation.py:_window_terms``), and the window
gradient w gi. Rows at or past ``count`` are zero.

- ``orient_terms`` is the entry point: it launches the kernel for a CUDA
  tensor and runs ``orient_terms_plain`` for a CPU tensor. There is no
  fallback from the kernel to the plain version.
- A row may come from any volume of a batch: with ``vol`` given, the level
  is (B, nz, ny, nx) and row k reads volume ``vol[k]``, in place. The TPU
  version gathers a stacked (B*K, wz, wy, wx) copy of the windows first;
  the kernel does not.
- On the H100 the kernel is bound by its float64 sums (see
  ``orient_work`` for the counts), which keep the keypoint rows exact: an
  fp32 sum can flip the 0.90 eigenvalue-ratio or the corner test.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..dtypes import F64
from ..features.windows import (batch_view, gather_windows, window_gradients,
                                window_starts, window_union)

# Window voxels per chunk of the plain version (bounds its temporaries).
_CHUNK_VOXELS = 1 << 22


def _constants(units, sigma: float, rad: float) -> dict:
    """fp32 constants shared bit for bit by the kernel and the plain
    version (rounded as the JAX package rounds them)."""
    u = [np.float32(x) for x in units]
    rad32, sig32 = np.float32(rad), np.float32(sigma)
    return dict(ux=float(u[0]), uy=float(u[1]), uz=float(u[2]),
                inv_ux=float(np.float32(1.0) / u[0]),
                inv_uy=float(np.float32(1.0) / u[1]),
                inv_uz=float(np.float32(1.0) / u[2]),
                rad2=float(rad32 * rad32), sig2=float(sig32 * sig32))


def _frame(shape, zyx, radii, cores, g):
    """Window starts, |v|^2 (C, cz, cy, cx) and the mask |d| <= R per axis
    of a chunk of rows with integer centres ``zyx`` (C, 3)."""
    starts = window_starts(shape, zyx, radii, cores)
    dev = zyx.device
    d = [(starts[:, a, None] + torch.arange(cores[a], device=dev)) -
         zyx[:, a, None] for a in range(3)]
    dz = d[0][:, :, None, None]
    dy = d[1][:, None, :, None]
    dx = d[2][:, None, None, :]
    Rz, Ry, Rx = radii
    in_box = ((dx.abs() <= Rx) & (dy.abs() <= Ry) & (dz.abs() <= Rz))
    vx = dx.float() * g["ux"]
    vy = dy.float() * g["uy"]
    vz = dz.float() * g["uz"]
    sq = vx * vx + vy * vy + vz * vz
    return starts, sq, in_box


def _plain_chunk(level, vol, zyx, radii, cores, units, g):
    starts, sq, in_box = _frame(level.shape[1:], zyx, radii, cores, g)
    mask = in_box & (sq <= g["rad2"])
    gx, gy, gz = window_gradients(gather_windows(level, vol, starts, cores),
                                  units)
    w = torch.exp(-0.5 * sq / g["sig2"])
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


def _kernel_fn():
    fn = _build.load("orient_window").sift3d_orient_window
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, I, I, P, I, I, I, I, I, I, I, I,
                       F, F, F, F, F, F, F, F, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def orient_terms(level, zyx, count: int, radii, cores, units, sigma: float,
                 rad: float, vol=None):
    """Structure-tensor sums of one level bucket.

    Args:
      level: (nz, ny, nx) f32 Gaussian pyramid level, or (B, nz, ny, nx)
        with ``vol``.
      zyx: (K, 3) integer keypoint centres (z, y, x), level voxel coords.
      count: number of real rows; rows >= count come back as zeros.
      radii, cores: (z, y, x) window half-extents and clamped core extents.
      units: (ux, uy, uz); sigma, rad: Gaussian width and window radius (mm).
      vol: optional (K,) volume index of each row.

    Returns (A6 (K, 6) float64 [xx, xy, xz, yy, yz, zz], vd (K, 3) float32).
    """
    if level.device.type == "cpu":
        return orient_terms_plain(level, zyx, count, radii, cores, units,
                                  sigma, rad, vol)
    if level.device.type != "cuda":
        raise ValueError(f"orient_terms: unsupported device {level.device}")
    if level.dtype != torch.float32 or level.ndim not in (3, 4):
        raise ValueError("orient_terms: level must be a 3-D or 4-D float32 "
                         "tensor")
    K = zyx.shape[0]
    level, vol = batch_view(level, K, vol)
    level = level.contiguous()
    rows = torch.cat([vol[:, None], zyx.to(device=level.device,
                                           dtype=torch.long)], 1)
    rows = rows.to(torch.int32).contiguous()
    A6 = torch.empty((K, 6), dtype=F64, device=level.device)
    vd = torch.empty((K, 3), dtype=torch.float32, device=level.device)
    if K == 0:
        return A6, vd
    g = _constants(units, sigma, rad)
    err = _kernel_fn()(
        level.data_ptr(), *level.shape[1:], rows.data_ptr(), K,
        min(int(count), K), *cores, *radii,
        g["ux"], g["uy"], g["uz"], g["inv_ux"], g["inv_uy"], g["inv_uz"],
        g["rad2"], g["sig2"], A6.data_ptr(), vd.data_ptr(),
        torch.cuda.current_stream(level.device).cuda_stream)
    _build.check(err, "orient_window launch")
    orient_terms.launches += 1
    return A6, vd


orient_terms.launches = 0

# Operations of the kernel for a voxel inside the box and the sphere: fp32
# displacement 3, |v|^2 5, Gaussian weight 3, gradients 9, weighted
# gradient 3; fp64 six products of three factors 12 and nine sums. A voxel
# of the box outside the sphere costs the displacement and |v|^2.
OPS32_ACTIVE_VOXEL = 23
OPS64_ACTIVE_VOXEL = 21
OPS32_BOX_VOXEL = 8


def orient_work(level, zyx, count: int, radii, cores, units, sigma: float,
                rad: float, vol=None) -> tuple[int, int, int]:
    """(bytes, fp32 operations, fp64 operations) that one ``orient_terms``
    call needs on these inputs: the union of the rows' windows (core +
    halo) read once per volume, each row's 4 ints read and its 6 doubles
    and 3 floats written; the operations counted from the voxels of each
    row's core that pass the box and sphere tests."""
    K = zyx.shape[0]
    level, vol = batch_view(level, K, vol)
    n = min(int(count), K)
    g = _constants(units, sigma, rad)
    zyx = zyx[:n].to(device=level.device, dtype=torch.long)
    starts = window_starts(level.shape[1:], zyx, radii, cores)
    nbytes = (4 * window_union(level.shape, vol[:n], starts, cores) +
              16 * n + K * (6 * 8 + 3 * 4))
    in_box = active = 0
    chunk = max(1, _CHUNK_VOXELS // (cores[0] * cores[1] * cores[2]))
    for k0 in range(0, n, chunk):
        _, sq, box = _frame(level.shape[1:], zyx[k0:k0 + chunk], radii,
                            cores, g)
        in_box += int(box.sum())
        active += int((box & (sq <= g["rad2"])).sum())
    ops32 = active * OPS32_ACTIVE_VOXEL + (in_box - active) * OPS32_BOX_VOXEL
    return nbytes, ops32, active * OPS64_ACTIVE_VOXEL
