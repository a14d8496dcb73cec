"""Descriptor window: the CUDA kernel (``csrc/descrip_window.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``_descrip_kernel_body`` of
``sift3d_tpu/ops/pallas_window.py``. Both versions compute, for each
keypoint row below ``count``, the raw 768-bin icosahedral gradient
histogram over the row's clamped core window of one pyramid level (see
the kernel source for the per-voxel steps); rows at or past ``count`` are
zero.

- ``descrip_window`` is the entry point: it launches the kernel for a
  CUDA tensor and runs ``descrip_window_plain`` for a CPU tensor. There is
  no fallback from the kernel to the plain version.
- A row may come from any volume of a batch: with ``vol`` given, the level
  is (B, nz, ny, nx) and row k reads volume ``vol[k]`` (the counterpart of
  the TPU version's ``custom_vmap``, which flattens (B, K) rows into one
  grid). The kernel reads every window straight from the level at its
  per-row volume and start; no stacked (B*K, wz, wy, wx) copy of the
  windows is built (that pre-gather is what ran the TPU version out of
  memory at the config-4 batch capacities).
- On the H100 the kernel is bound by arithmetic and shared-memory atomics,
  not by device memory (see ``descrip_work`` for the counts).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..config import (BARY_EPS, DESC_NUM_TOTAL_HIST, DESC_NUMEL, NHIST_PER_DIM)
from ..features.windows import (batch_view, gather_windows, window_gradients,
                                window_starts, window_union)
from .geometry import face_solve_tables, face_tables, icos_hist_bin, vertex_weights

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


def _window_frame(shape, centers, R, radii, cores, g):
    """Window starts and the per-voxel displacement frame of a chunk of
    rows of a (nz, ny, nx) level: returns (starts, sq (C, cz, cy, cx),
    (vbx, vby, vbz), in_sphere)."""
    dev = centers.device
    starts = window_starts(shape, torch.floor(centers).long(), radii, cores)
    cz, cy, cx = cores
    zg = (starts[:, 0, None] + torch.arange(cz, device=dev)).float()
    yg = (starts[:, 1, None] + torch.arange(cy, device=dev)).float()
    xg = (starts[:, 2, None] + torch.arange(cx, device=dev)).float()
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
    return starts, sq, vb, in_sphere


def _plain_chunk(level, vol, centers, R, radii, cores, units, g):
    """Raw histograms (C, 768) of a chunk of keypoints."""
    C = centers.shape[0]
    V = cores[0] * cores[1] * cores[2]
    starts, sq, (vbx, vby, vbz), in_sphere = _window_frame(
        level.shape[1:], centers, R, radii, cores, g)
    nh = float(NHIST_PER_DIM)
    inside = ((vbx >= 0) & (vby >= 0) & (vbz >= 0) &
              (vbx < nh) & (vby < nh) & (vbz < nh))

    win = gather_windows(level, vol, starts, cores)
    gx, gy, gz = window_gradients(win, units)
    weight = torch.exp(-0.5 * sq / g["sig2"])
    gx = gx * weight; gy = gy * weight; gz = gz * weight
    Rc = [[R[:, j, i, None, None, None] for j in range(3)] for i in range(3)]
    grad_rot = torch.stack(
        [Rc[i][0] * gx + Rc[i][1] * gy + Rc[i][2] * gz for i in range(3)],
        dim=-1).reshape(C, V, 3)
    face, bary, ok = icos_hist_bin(grad_rot)
    mag = torch.sqrt(torch.sum(grad_rot * grad_rot, -1))
    total_mask = (in_sphere & inside).reshape(C, V) & ok
    Gmat = vertex_weights(face, bary) * (mag * total_mask)[..., None]

    # Trilinear spatial weights over the 4^3 histogram grid
    # (SIFT3D_desc_acc_interp, sift.c:1732-1755).
    b = torch.arange(NHIST_PER_DIM, device=level.device)

    def axis_w(vb):
        vb = vb.reshape(C, V)
        flo = torch.floor(vb)
        fr = (vb - flo)[..., None]
        flo = flo.long()[..., None]
        return ((flo == b) * (1.0 - fr) + ((flo + 1) == b) * fr).float()
    wx, wy, wz = axis_w(vbx), axis_w(vby), axis_w(vbz)
    S = (wz[..., :, None, None] * wy[..., None, :, None] *
         wx[..., None, None, :]).reshape(C, V, DESC_NUM_TOTAL_HIST)
    hist = torch.bmm(S.transpose(1, 2), Gmat)          # (C, 64, 12)
    return hist.reshape(C, DESC_NUMEL)


def descrip_window_plain(level, centers, R, count: int, radii, cores,
                         units, sigma: float, rad: float,
                         vol=None) -> torch.Tensor:
    """The plain PyTorch version: raw (K, 768) histograms, chunked over
    keypoints; rows >= count are zero."""
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
        out[k0:k1] = _plain_chunk(level, vol[k0:k1], centers[k0:k1],
                                  R[k0:k1], radii, cores, units, g)
    return out


_tables_cache: dict = {}


def _tables(device):
    t = _tables_cache.get(device)
    if t is None:
        normals, vinv = face_solve_tables()
        tab = np.concatenate([normals.reshape(-1), vinv.reshape(-1)])
        t = _tables_cache[device] = (
            torch.as_tensor(tab, dtype=torch.float32, device=device),
            torch.as_tensor(face_tables()["idx"], dtype=torch.int32,
                            device=device).contiguous())
    return t


def _kernel_fn():
    fn = _build.load("descrip_window").sift3d_descrip_window
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, I, I, P, P, P, P, I, I, I, I, I,
                       F, F, F, F, F, F, F, F, F, F, F, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def descrip_window(level, centers, R, count: int, radii, cores, units,
                   sigma: float, rad: float, vol=None) -> torch.Tensor:
    """Raw (K, 768) descriptor histograms of one level bucket.

    Args:
      level: (nz, ny, nx) f32 Gaussian pyramid level, or (B, nz, ny, nx)
        with ``vol``.
      centers: (K, 3) keypoint centers (z, y, x), level voxel coords.
      R: (K, 3, 3) rotations.
      count: number of real rows; rows >= count come back as zeros.
      radii, cores: (z, y, x) window half-extents and clamped core extents.
      units: (ux, uy, uz); sigma, rad: descriptor Gaussian width and
        window radius (mm).
      vol: optional (K,) volume index of each row.
    """
    if level.device.type == "cpu":
        return descrip_window_plain(level, centers, R, count, radii, cores,
                                    units, sigma, rad, vol)
    if level.device.type != "cuda":
        raise ValueError(f"descrip_window: unsupported device {level.device}")
    if level.dtype != torch.float32 or level.ndim not in (3, 4):
        raise ValueError("descrip_window: level must be a 3-D or 4-D float32 "
                         "tensor")
    K = centers.shape[0]
    level, vol = batch_view(level, K, vol)
    level = level.contiguous()
    vol = vol.to(torch.int32).contiguous()
    centers = centers.to(device=level.device, dtype=torch.float32).contiguous()
    rot = R.to(device=level.device, dtype=torch.float32).reshape(K, 9).contiguous()
    starts = window_starts(level.shape[1:], torch.floor(centers).long(),
                           radii, cores).to(torch.int32).contiguous()
    out = torch.empty((K, DESC_NUMEL), dtype=torch.float32, device=level.device)
    if K == 0:
        return out
    tables, face_idx = _tables(level.device)
    g = geometry_constants(units, sigma, rad)
    err = _kernel_fn()(
        level.data_ptr(), *level.shape[1:], vol.data_ptr(), starts.data_ptr(),
        centers.data_ptr(), rot.data_ptr(), K, min(int(count), K), *cores,
        g["ux"], g["uy"], g["uz"], g["inv_ux"], g["inv_uy"], g["inv_uz"],
        g["rad2"], g["sig2"], g["half_width"], g["bin_fctr"], g["bary_eps"],
        tables.data_ptr(), face_idx.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(level.device).cuda_stream)
    _build.check(err, "descrip_window launch")
    descrip_window.launches += 1
    return out


descrip_window.launches = 0

# fp32 operations the kernel does for a voxel that passes the sphere and
# bin-cube tests (displacement rotation and bin coordinates 21, Gaussian
# weight 4, gradient 12, gradient rotation 15, |g|^2 5, face scan 100,
# barycentrics 17, |g| and scaling 7, hat weights 6, 24 weighted updates
# 72), and for every other voxel of the box (displacement and |v|^2 11).
OPS_ACTIVE_VOXEL = 259
OPS_BOX_VOXEL = 11


def descrip_work(level, centers, R, count: int, radii, cores, units,
                 sigma: float, rad: float, vol=None) -> tuple[int, int]:
    """(bytes, fp32 operations) that one ``descrip_window`` call needs on
    these inputs: the union of the rows' windows (core + halo) read once
    per volume (windows of nearby keypoints overlap), each row's inputs
    read and its histogram written once; the operations counted from the
    voxels of each box that pass the sphere and bin-cube tests."""
    level, vol = batch_view(level, centers.shape[0], vol)
    n = min(int(count), centers.shape[0])
    starts = window_starts(level.shape[1:], torch.floor(centers[:n]).long(),
                           radii, cores)
    covered = window_union(level.shape, vol[:n], starts, cores)
    g = geometry_constants(units, sigma, rad)
    nh = float(NHIST_PER_DIM)
    box = cores[0] * cores[1] * cores[2]
    active = 0
    chunk = max(1, _CHUNK_VOXELS // box)
    for k0 in range(0, n, chunk):
        _, _, (vbx, vby, vbz), in_sphere = _window_frame(
            level.shape[1:], centers[k0:k0 + chunk].float(), R[k0:k0 + chunk].float(),
            radii, cores, g)
        inside = ((vbx >= 0) & (vby >= 0) & (vbz >= 0) &
                  (vbx < nh) & (vby < nh) & (vbz < nh))
        active += int((in_sphere & inside).sum())
    nbytes = (4 * covered + n * 4 * (1 + 3 + 3 + 9) +
              centers.shape[0] * DESC_NUMEL * 4)
    ops = active * OPS_ACTIVE_VOXEL + (n * box - active) * OPS_BOX_VOXEL
    return nbytes, ops
