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
- Before, the kernel ran one block per row (a 256^3 level bucket of 1-25
  rows filled at most 25 of 132 SMs), walked every voxel of the box, and
  its float shared atomics (compare-and-swap loops on sm_90) serialized.
  Now the grid is rows x z-slabs (``slab_plan``: at least 2 x 132 blocks
  where rows x planes allow it; slab partials summed in slab order by a
  second pass, the split that ``descrip_window_plain(..., planes=...)``
  repeats), each (z, y) line is cut to its span in the sphere and the
  rotated bin cube (``line_span``) and the candidates are laid out densely
  over the threads, and bins are added as fixed-point integers with native
  shared atomics into a private histogram per warp, folded into fp32
  every 2048 candidates. The fixed-point step of a block follows the range
  of the values its slab reads (from a first pass that takes the min and
  max of each 8^3 tile of the level), so a dark window in a bright level
  is summed as finely as a bright one; a voxel whose gradient is under
  2^8 steps goes to a histogram (one per pair of warps) 2^13 times finer,
  so dark voxels that share a slab with a bright structure (whole-volume
  windows of the raw-image path) are not rounded away.
- On the H100 the kernel is bound by its fp32 arithmetic per voxel, not by
  device memory (see ``descrip_work`` for the counts); at small buckets by
  the launches' host overhead.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from .._build import NUM_SMS
from ..config import (BARY_EPS, DESC_NUM_TOTAL_HIST, DESC_NUMEL, NHIST_PER_DIM)
from ..features.windows import (batch_view, gather_windows, union_mask,
                                window_gradients, window_starts,
                                window_union)
from ..utils import trace
from .geometry import face_solve_tables, face_tables, icos_hist_bin, vertex_weights

# Window voxels per chunk of the plain version (bounds its temporaries:
# about 0.5 KB per voxel).
_CHUNK_VOXELS = 1 << 22
# Margins of the kernel's line spans (``line_span``): the bin-cube cut in
# bin units, and the slope below which a line runs parallel to a face.
BIN_EPS = 1e-3
FLAT = 1e-6


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


def _chunk_terms(level, vol, centers, R, radii, cores, units, g,
                 z_range=None):
    """Per-voxel terms of a chunk of C rows over the core planes [z0, z1)
    of ``z_range`` (all planes when None): bin coordinates (vbx, vby, vbz)
    and ``voxel_terms`` over the voxels in the sphere."""
    starts, sq, vb, in_sphere = _window_frame(
        level.shape[1:], centers, R, radii, cores, g)
    if z_range is not None:
        iz = torch.arange(cores[0], device=level.device)
        in_sphere = in_sphere & ((iz >= z_range[0]) &
                                 (iz < z_range[1]))[None, :, None, None]
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


def _plain_chunk(level, vol, centers, R, radii, cores, units, g,
                 z_range=None):
    """Raw histograms (C, 768) of a chunk of keypoints, over the core
    planes [z0, z1) of ``z_range`` when it is given."""
    return histograms(*_chunk_terms(level, vol, centers, R, radii, cores,
                                    units, g, z_range))


def descrip_window_plain(level, centers, R, count: int, radii, cores,
                         units, sigma: float, rad: float, vol=None,
                         planes: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: raw (K, 768) histograms, chunked over
    keypoints; rows >= count are zero. With ``planes``, each row's core is
    split into z-slabs of that many planes, each slab's histogram is
    computed alone and the slabs are summed in order (the kernel's split)."""
    K = centers.shape[0]
    level, vol = batch_view(level, K, vol)
    out = torch.zeros((K, DESC_NUMEL), dtype=torch.float32,
                      device=level.device)
    n = min(int(count), K)
    g = geometry_constants(units, sigma, rad)
    chunk = max(1, _CHUNK_VOXELS // (cores[0] * cores[1] * cores[2]))
    centers = centers.float()
    R = R.float()
    slabs = [None] if planes is None else \
        [(z0, z0 + planes) for z0 in range(0, cores[0], planes)]
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        for z_range in slabs:
            out[k0:k1] += _plain_chunk(level, vol[k0:k1], centers[k0:k1],
                                       R[k0:k1], radii, cores, units, g,
                                       z_range)
    return out


def slab_plan(rows: int, cz: int) -> tuple[int, int]:
    """(core planes per slab, slabs per row) of a kernel launch over
    ``rows`` rows of core depth ``cz``: the grid (rows x slabs blocks)
    reaches 2 x NUM_SMS where rows x cz allows it; a bucket that fills the
    card alone takes one slab per row."""
    want = -(-2 * NUM_SMS // max(1, rows))
    planes = max(1, cz // want)
    return planes, -(-cz // planes)


def line_span(center, y: int, z: int, R, g: dict, sx: int,
              cx: int) -> tuple[int, int] | None:
    """The kernel's x-span [x_lo, x_hi] of the core line (y, z), in fp32 as
    on the card: every voxel of the line inside the sphere and the rotated
    bin cube lies in it (each cut widened by one voxel). ``center`` is
    (z, y, x) in level voxels, ``R`` the row's 3x3 rotation, ``g`` from
    ``geometry_constants``, [sx, sx + cx) the core. None when empty."""
    f = np.float32
    cz_, cy_, cx_ = (f(c) for c in center)
    R = np.asarray(R, np.float32)
    vy = f(f(f(y) - cy_) * f(g["uy"]))
    vz = f(f(f(z) - cz_) * f(g["uz"]))
    rad2 = f(g["rad2"])
    yz = f(vy * vy + vz * vz)
    if not yz <= rad2:
        return None
    half = f(f(np.sqrt(f(rad2 - yz))) * f(g["inv_ux"]))
    t_lo, t_hi = -half, half
    bf, hw = f(g["bin_fctr"]), f(g["half_width"])
    k_lo = f(f(-f(BIN_EPS) / bf) - hw)
    k_hi = f(f(f(4.0 + BIN_EPS) / bf) - hw)
    for i in range(3):
        a = f(R[1, i] * vy + R[2, i] * vz)
        b = f(R[0, i] * f(g["ux"]))
        if abs(b) > FLAT:
            t0, t1 = f((k_lo - a) / b), f((k_hi - a) / b)
            if b < 0:
                t0, t1 = t1, t0
            t_lo, t_hi = max(t_lo, t0), min(t_hi, t1)
        elif not k_lo <= a <= k_hi:
            return None
    lo = max(sx, int(np.ceil(f(cx_ + t_lo))) - 1)
    hi = min(sx + cx - 1, int(np.floor(f(cx_ + t_hi))) + 1)
    return (lo, hi) if lo <= hi else None


_tables_cache: dict = {}


def _tables(device):
    """(host normals (20, 3) f32, device normals + inverse vertex
    matrices, device face vertex indices) of the icosahedron."""
    t = _tables_cache.get(device)
    if t is None:
        normals, vinv = face_solve_tables()
        normals = np.ascontiguousarray(normals, dtype=np.float32)
        tab = np.concatenate([normals.reshape(-1), vinv.reshape(-1)])
        t = _tables_cache[device] = (
            normals,
            torch.as_tensor(tab, dtype=torch.float32, device=device),
            torch.as_tensor(face_tables()["idx"], dtype=torch.int32,
                            device=device).contiguous())
    return t


def blocks_per_sm() -> int:
    """Blocks of the kernel that share an SM of the current card once the
    launcher has set its shared-memory carveout (``kBlocksPerSm``, 4, in
    ``csrc/descrip_window.cu``; more blocks leave L1 too small for the
    window reads)."""
    fn = _build.load("descrip_window").sift3d_descrip_blocks_per_sm
    fn.restype = ctypes.c_int
    n = fn()
    if n < 0:
        _build.check(-n, "descrip_window carveout")
    return n


def _kernel_fn():
    fn = _build.load("descrip_window").sift3d_descrip_window
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, I, I, I, P, P, P, I, I, I, I, I, I, I, I, I, I,
                       F, F, F, F, F, F, F, F, F, F, F, P, P, P, P, P, P, P]
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
    level = level.contiguous()
    if level.ndim == 3:
        level = level[None]
    if vol is not None:        # else every row reads volume 0
        vol = vol.to(device=level.device, dtype=torch.int32).contiguous()
    centers = centers.to(device=level.device,
                         dtype=torch.float32).contiguous()
    rot = R.to(device=level.device, dtype=torch.float32).reshape(K, 9)
    rot = rot.contiguous()
    n = max(0, min(int(count), K))
    planes, slabs = slab_plan(n, cores[0])
    scratch = n * slabs * DESC_NUMEL if slabs > 1 else 0
    # (min, max) of each 8^3 tile of the level: sets the kernel's
    # fixed-point step per block.
    tiles = level.shape[0] * math.prod(-(-d // 8) for d in level.shape[1:])
    buf = torch.empty(K * DESC_NUMEL + scratch + 2 * tiles,
                      dtype=torch.float32, device=level.device)
    out = buf[:K * DESC_NUMEL].view(K, DESC_NUMEL)
    if K == 0:
        return out
    normals, tables, face_idx = _tables(level.device)
    g = geometry_constants(units, sigma, rad)
    err = _kernel_fn()(
        level.data_ptr(), *level.shape,
        None if vol is None else vol.data_ptr(), centers.data_ptr(),
        rot.data_ptr(), K, n, *radii, *cores, planes, slabs,
        g["ux"], g["uy"], g["uz"], g["inv_ux"], g["inv_uy"], g["inv_uz"],
        g["rad2"], g["sig2"], g["half_width"], g["bin_fctr"], g["bary_eps"],
        normals.ctypes.data, tables.data_ptr(), face_idx.data_ptr(),
        out.data_ptr(), buf[K * DESC_NUMEL:].data_ptr() if scratch else None,
        buf[K * DESC_NUMEL + scratch:].data_ptr(),
        torch.cuda.current_stream(level.device).cuda_stream)
    _build.check(err, "descrip_window launch")
    trace.count("launches.descrip_window")
    return out


# The fp32 operations the function needs (each add, multiply, comparison,
# division, sqrt, exp or floor counts one; constants of a call or a row
# are folded; what a line's voxels share is counted once a line):
# - a core line of a box: its span in the sphere and the rotated bin cube
#   (line_span: y and z displacements 4, y^2 + z^2 and its test 4, the
#   half chord 3, per bin axis the line's offset, two crossings and the
#   clamps 9, the span's ends 4);
# - a voxel of the span in the sphere and the bin cube, up to the |g|^2
#   test: x displacement and |v|^2 4, sphere test 1, rotation and bin
#   coordinates 12, bin-cube tests 6, Gaussian weight 2, weighted gradient
#   9, its rotation 15, |g|^2 and its test 6;
# - a voxel that also adds to the histogram (icos_hist_bin's ``ok``): the
#   face scan 69 (10 dot products, the other 10 faces being their
#   antipodes, and 19 comparisons), barycentrics, their sum and test 18,
#   |g| / sum and the three weights 5, hat weights 9, the 8 spatial
#   weights 12, 24 weighted bin updates 48.
# Voxels of the box outside the span need nothing.
OPS_LINE = 42
OPS_GEOMETRY_VOXEL = 55
OPS_CONTRIB_VOXEL = OPS_GEOMETRY_VOXEL + 161


def descrip_active(level, centers, R, count: int, radii, cores, units,
                   sigma: float, rad: float, vol=None) -> tuple[int, int, int]:
    """(voxels that add to a histogram, voxels that pass the sphere and
    bin-cube tests, voxels of the boxes) of one ``descrip_window`` call's
    rows below ``count``."""
    level, vol = batch_view(level, centers.shape[0], vol)
    n = min(int(count), centers.shape[0])
    g = geometry_constants(units, sigma, rad)
    box = cores[0] * cores[1] * cores[2]
    contrib = geometry = 0
    chunk = max(1, _CHUNK_VOXELS // box)
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        *_, ok, geom = _chunk_terms(level, vol[k0:k1], centers[k0:k1].float(),
                                    R[k0:k1].float(), radii, cores, units, g)
        contrib += int((geom & ok).sum())
        geometry += int(geom.sum())
    return contrib, geometry, n * box


def descrip_work(level, centers, R, count: int, radii, cores, units,
                 sigma: float, rad: float, vol=None,
                 masks: dict | None = None) -> tuple[int, ...]:
    """(bytes, fp32 operations) that one ``descrip_window`` call needs on
    these inputs, followed by ``descrip_active``'s three voxel counts. The
    bytes: the union of the rows' windows (core + halo) read once per
    volume (windows of nearby keypoints overlap), each row's inputs read
    and its histogram written once; the operations: ``OPS_*`` over the
    rows' core lines and the voxels that pass the tests. With ``masks``
    (``union_mask``), shared by the calls of one path, voxels that an
    earlier call on the same tensor read are not counted again (the
    raw-image path's buckets all read one smoothed image)."""
    level, vol = batch_view(level, centers.shape[0], vol)
    n = min(int(count), centers.shape[0])
    starts = window_starts(level.shape[1:], torch.floor(centers[:n]).long(),
                           radii, cores)
    covered = window_union(level.shape, vol[:n], starts, cores,
                           None if masks is None else
                           union_mask(masks, level))
    contrib, geometry, boxes = descrip_active(
        level, centers, R, count, radii, cores, units, sigma, rad, vol)
    nbytes = (4 * covered + n * 4 * (1 + 3 + 3 + 9) +
              centers.shape[0] * DESC_NUMEL * 4)
    ops = (n * cores[0] * cores[1] * OPS_LINE +
           geometry * OPS_GEOMETRY_VOXEL +
           contrib * (OPS_CONTRIB_VOXEL - OPS_GEOMETRY_VOXEL))
    return nbytes, ops, contrib, geometry, boxes
