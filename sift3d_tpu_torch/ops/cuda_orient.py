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

- ``orient_terms_levels`` is the entry point: the rows of every level of a
  detection in one kernel launch for CUDA tensors (one per MAX_LEVELS
  levels with rows, ``level_groups``), and a loop of
  ``orient_terms_plain`` over the levels for CPU tensors
  (``orient_terms_levels_plain``). There is no fallback from the kernel to
  the plain version.
- ``orient_terms`` is its one-level case, with the rows given as centres
  and an optional volume index.
- A row may come from any volume of a batch: row k of a (B, nz, ny, nx)
  level reads volume ``vol[k]``, in place. The TPU version gathers a
  stacked (B*K, wz, wy, wx) copy of the windows first; the kernel does not.
- The kernel walks, per level, the list of window offsets inside the
  sphere with their weights (``offset_table``), built per level geometry
  with the plain version's own operations, so that masks and weights are
  the plain version's bit for bit; a row's list is split over
  ``warps_per_row`` warps. Tables are cached per geometry up to
  ``TABLE_CACHE_BYTES``, least recently used first out.
- A level whose table would hold an extent past ``MAX_EXTENT`` (the 10-bit
  packing) or more than ``BOX_WALK_ENTRIES`` offsets in its box has no
  table (``box_walk``): its rows walk their core boxes and the kernel forms
  the mask and the weights per voxel by the plain version's operations.
  The raw-image path's windows meet such levels from octave 4 on (they
  span up to a whole volume): there a table is a 16-byte load per voxel
  from device memory, and the walk is faster; below, a table held in the
  caches is (``scripts/orient_walk_ab.py``). A 600 x 512 x 512 volume's
  levels (6, 1) and (6, 2) have extents (581, 509, 509) and (597, 509,
  509), past the packing: their tables would hold up to 1.2 G entries.
- The float64 sums keep the keypoint rows exact (an fp32 sum can flip the
  0.90 eigenvalue-ratio or the corner test); on the H100 they set the
  function's bound (``orient_work`` counts it), while the kernel's time
  is set by its level loads (see the source's header).
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..dtypes import F64
from ..features.windows import (batch_view, gather_windows, union_mask,
                                window_gradients, window_starts,
                                window_union)
from ..utils import trace

# Window voxels per chunk of the plain version (bounds its temporaries).
_CHUNK_VOXELS = 1 << 22
# The kernel's limits: levels per launch (its parameter table; more levels
# take more launches), rows per block (warps of a 256-thread block), table
# offsets per axis (packed in 10 bits each, ``_pack``).
MAX_LEVELS = 32
WARPS = 8
MAX_EXTENT = 511
# Bytes of tables kept between calls.
TABLE_CACHE_BYTES = 1 << 30
# Offsets in a table's box above which a level has no table and its rows
# walk their boxes (``box_walk``). Each raw 256^3 level alone, kernel ms
# by table and by box walk: box 6.3 M offsets (3.2 M entries) 8.60 / 8.59,
# 12.6 M 15.58 / 5.69, 49.4 M 49.88 / 25.72; at the pyramid levels' 1,331-
# 15,625 offsets the tables halve a 256^3 registration's and a config-4
# batch's kernel time (``scripts/orient_walk_ab.py``, NVIDIA H100 80GB
# HBM3, 700 W). Below it a table holds at most 134 MB and is built in one
# pass.
BOX_WALK_ENTRIES = 1 << 23
# Table entries a warp should walk at most: a row's list is split over
# more warps (up to WARPS) until it does.
ENTRIES_PER_WARP = 512


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


def _frame(shape, zyx, radii, cores, g):
    """Window starts, |v|^2 (C, cz, cy, cx) and the mask |d| <= R per axis
    of a chunk of rows with integer centres ``zyx`` (C, 3)."""
    starts = window_starts(shape, zyx, radii, cores)
    d = _offsets(starts, zyx, cores)
    return starts, _sq(*d, g), _in_box(d, radii)


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


def table_extents(radii, cores) -> tuple[int, int, int]:
    """(z, y, x) extents of a level's offset table: |d| <= min(R, core - 1)
    per axis. A row's centre lies in its core, so a voxel of its core is at
    most core - 1 from it."""
    return tuple(min(r, c - 1) for r, c in zip(radii, cores))


def box_walk(radii, cores) -> bool:
    """True when a level's rows walk their core boxes instead of an offset
    table: an extent past MAX_EXTENT, or more than BOX_WALK_ENTRIES
    offsets in the table's box."""
    ext = table_extents(radii, cores)
    return (max(ext) > MAX_EXTENT or
            math.prod(2 * e + 1 for e in ext) > BOX_WALK_ENTRIES)


def _pack(dz, dy, dx):
    """Offsets |d| <= MAX_EXTENT as one non-negative int32: 10 bits an
    axis, biased by 512."""
    return ((dz + 512) << 20) | ((dy + 512) << 10) | (dx + 512)


def unpack(packed):
    """(dz, dy, dx) of the table's packed offsets (the kernel's rule)."""
    return (((packed >> 20) & 0x3FF) - 512, ((packed >> 10) & 0x3FF) - 512,
            (packed & 0x3FF) - 512)


def offset_table(shape, radii, cores, units, sigma: float, rad: float,
                 device) -> torch.Tensor:
    """(E, 4) int32 list of a level's window offsets d inside the sphere
    (|d| <= ``table_extents`` per axis, |v|^2 <= rad^2), in (dz, dy, dx)
    order: the level offset (dz ny + dy) nx + dx, the packed offset
    (``unpack``) and the weight w as a float64's two 32-bit words. |v|^2,
    the mask and w are formed by the plain version's operations on
    ``device``, so they are its values bit for bit. Raises when an extent
    exceeds MAX_EXTENT or a level offset would not fit in int32."""
    g = _constants(units, sigma, rad)
    ext = table_extents(radii, cores)
    if max(ext) > MAX_EXTENT:
        raise ValueError(f"orient_window: window extents {ext} exceed "
                         f"{MAX_EXTENT}")
    ny, nx = shape[-2:]
    if (ext[0] * ny + ext[1]) * nx + ext[2] >= 2 ** 31:
        raise ValueError(f"orient_window: level offsets of extents {ext} in "
                         f"a {tuple(shape)} level exceed int32")
    ez, ey, ex = ext
    dz = torch.arange(-ez, ez + 1, device=device)[:, None, None]
    dy = torch.arange(-ey, ey + 1, device=device)[None, :, None]
    dx = torch.arange(-ex, ex + 1, device=device)[None, None, :]
    sq = _sq(dz, dy, dx, g)
    mask = sq <= g["rad2"]
    w = _weight(sq, g)[mask].to(F64)
    iz, iy, ix = torch.nonzero(mask, as_tuple=True)
    del sq, mask
    pz, py, px = iz - ez, iy - ey, ix - ex
    off = (pz * ny + py) * nx + px
    return torch.cat(
        [torch.stack([off, _pack(pz, py, px)], 1).to(torch.int32),
         w.view(torch.int32).reshape(-1, 2)], 1).contiguous()


def warps_per_row(entries: int) -> int:
    """Warps that split one row's table walk: the least power of two up to
    WARPS that leaves each at most ENTRIES_PER_WARP entries."""
    p = 1
    while p < WARPS and p * ENTRIES_PER_WARP < entries:
        p *= 2
    return p


class _Level(ctypes.Structure):
    """The kernel's ``Sift3dOrientLevel`` (``csrc/orient_window.cu``)."""
    _fields_ = ([("level", ctypes.c_void_p), ("table", ctypes.c_void_p)] +
                [(f, ctypes.c_int) for f in (
                    "nz", "ny", "nx", "cz", "cy", "cx", "rz", "ry", "rx",
                    "ez", "ey", "ex", "entries", "log2_warps", "row0", "rows",
                    "count", "block0")] +
                [(f, ctypes.c_float) for f in ("inv_ux", "inv_uy", "inv_uz",
                                                "ux", "uy", "uz", "rad2",
                                                "w_scale")])


class _TableCache:
    """Per-geometry ``_level_static`` entries, least recently used first
    out once their tables hold more than ``limit`` bytes; a table larger
    than ``limit`` alone is built for its call and not kept."""

    def __init__(self, limit: int):
        self.limit = limit
        self.bytes = 0
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        st = self.entries.get(key)
        if st is not None:
            self.entries.move_to_end(key)
        return st

    def clear(self) -> None:
        self.entries.clear()
        self.bytes = 0

    def put(self, key, st) -> None:
        size = st[2].numel() * st[2].element_size()
        if size > self.limit:
            return
        self.entries[key] = st
        self.bytes += size
        while self.bytes > self.limit:
            _, old = self.entries.popitem(last=False)
            self.bytes -= old[2].numel() * old[2].element_size()


_statics = _TableCache(TABLE_CACHE_BYTES)


def _level_static(shape, radii, cores, units, sigma, rad, device):
    """(the kernel's ``_Level`` with the fields that depend on the level's
    geometry alone, rows per block, the offset table), cached per geometry
    and device: detections of one plan reuse them. A ``box_walk`` level
    has an empty table and a null table pointer."""
    key = (str(device), tuple(shape), tuple(radii), tuple(cores),
           tuple(units), sigma, rad)
    st = _statics.get(key)
    if st is None:
        ext = table_extents(radii, cores)
        if box_walk(radii, cores):
            tab = torch.empty((0, 4), dtype=torch.int32, device=device)
            P = warps_per_row(math.prod(2 * e + 1 for e in ext))
        else:
            tab = offset_table(shape, radii, cores, units, sigma, rad,
                               device)
            P = warps_per_row(tab.shape[0])
        g = _constants(units, sigma, rad)
        lv = _Level(0, tab.data_ptr() if tab.numel() else None, *shape,
                    *cores, *radii, *ext, tab.shape[0], P.bit_length() - 1,
                    0, 0, 0, 0, g["inv_ux"], g["inv_uy"], g["inv_uz"],
                    g["ux"], g["uy"], g["uz"], g["rad2"], g["w_scale"])
        st = (lv, WARPS // P, tab)
        _statics.put(key, st)
    return st


def _kernel_fn():
    fn = _build.load("orient_window").sift3d_orient_levels
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def level_groups(levels) -> list[list[int]]:
    """The launches of one ``orient_terms_levels`` call: the indices of
    the levels with rows, in order, in groups of at most MAX_LEVELS (one
    group, so one launch, at every configuration the repo runs)."""
    used = [i for i, lv in enumerate(levels) if lv[1]]
    return [used[j:j + MAX_LEVELS] for j in range(0, len(used), MAX_LEVELS)]


def orient_terms_levels(rows, levels):
    """Structure-tensor sums of the rows of many levels, one launch per
    ``level_groups`` group.

    Args:
      rows: (N, 4) integer rows (volume, z, y, x) of all levels, level by
        level, in level voxel coords.
      levels: per level, (level, n, count, radii, cores, units, sigma, rad):
        the (B, nz, ny, nx) (or (nz, ny, nx)) f32 Gaussian level, its next
        n rows of ``rows``, of which those at or past ``count`` come back
        as zeros, the (z, y, x) window half-extents and clamped core
        extents, (ux, uy, uz), and the Gaussian width and window radius
        (mm).

    Returns (A6 (N, 6) float64 [xx, xy, xz, yy, yz, zz], vd (N, 3) float32).
    """
    dev = rows.device
    if any(lv[0].device != dev for lv in levels):
        raise ValueError("orient_terms_levels: rows and levels on different "
                         "devices")
    if dev.type == "cpu":
        return orient_terms_levels_plain(rows, levels)
    if dev.type != "cuda":
        raise ValueError(f"orient_terms_levels: unsupported device {dev}")
    if any(lv[0].dtype != torch.float32 or lv[0].ndim not in (3, 4)
           for lv in levels):
        raise ValueError("orient_terms_levels: a level must be a 3-D or 4-D "
                         "float32 tensor")
    N = rows.shape[0]
    row0 = np.cumsum([0] + [lv[1] for lv in levels]).tolist()
    if row0[-1] != N:
        raise ValueError("orient_terms_levels: the levels' row counts do not "
                         "add up to the rows")
    A6 = torch.empty((N, 6), dtype=F64, device=dev)
    vd = torch.empty((N, 3), dtype=torch.float32, device=dev)
    rows = rows.to(torch.int32).contiguous()
    # The levels' contiguous copies and their offset tables, held until
    # their kernels are queued: the launch passes only their addresses.
    held = []
    for group in level_groups(levels):
        table = (_Level * len(group))()
        block0 = 0
        for i, j in enumerate(group):
            level, n, count, radii, cores, units, sigma, rad = levels[j]
            level = level.contiguous()
            lv, per_block, tab = _level_static(level.shape[-3:], radii, cores,
                                               units, sigma, rad, dev)
            held += [level, tab]
            table[i] = lv
            e = table[i]
            e.level, e.block0 = level.data_ptr(), block0
            e.row0, e.rows, e.count = row0[j], n, min(max(int(count), 0), n)
            block0 += -(-n // per_block)
        err = _kernel_fn()(
            ctypes.addressof(table), len(group), block0, rows.data_ptr(),
            A6.data_ptr(), vd.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "orient_window launch")
        trace.count("launches.orient_window")
    return A6, vd



def orient_terms(level, zyx, count: int, radii, cores, units, sigma: float,
                 rad: float, vol=None):
    """Structure-tensor sums of one level bucket (``orient_terms_levels``
    with one level).

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
    K = zyx.shape[0]
    level, vol = batch_view(level, K, vol)
    rows = torch.cat([vol[:, None], zyx.to(device=level.device,
                                           dtype=torch.long)], 1)
    return orient_terms_levels(rows, [(level, K, count, radii, cores, units,
                                       sigma, rad)])


# Operations the function needs (each add, multiply, comparison,
# division or exp counts one): per offset of a level's table box, once a
# call (the weights depend on the offset alone), the displacement 3,
# |v|^2 5, the sphere test 1 and the weight 3; per voxel in the box and the
# sphere, the fp32 gradients 9 and in fp64 the three products w gi, the
# six products (w gi) gj and the nine sums (as the TPU kernel forms them).
OPS32_OFFSET = 12
OPS32_VOXEL = 9
OPS64_VOXEL = 18


def orient_work(level, zyx, count: int, radii, cores, units, sigma: float,
                rad: float, vol=None,
                masks: dict | None = None) -> tuple[int, int, int, int]:
    """(bytes, fp32 operations, fp64 operations, voxels counted) that one
    level's rows need (``orient_terms``' arguments): the union of the rows'
    windows (core + halo) read once per volume, each row's 4 ints read and
    its 6 doubles and 3 floats written; the operations from ``OPS_*`` over
    the level's table box and the voxels of each row's core that pass the
    box and sphere tests. With ``masks`` (``union_mask``), voxels that an
    earlier level on the same tensor read are not counted again."""
    K = zyx.shape[0]
    level, vol = batch_view(level, K, vol)
    n = min(int(count), K)
    g = _constants(units, sigma, rad)
    zyx = zyx[:n].to(device=level.device, dtype=torch.long)
    starts = window_starts(level.shape[1:], zyx, radii, cores)
    covered = None if masks is None else union_mask(masks, level)
    nbytes = (4 * window_union(level.shape, vol[:n], starts, cores, covered) +
              16 * n + K * (6 * 8 + 3 * 4))
    active = 0
    chunk = max(1, _CHUNK_VOXELS // (cores[0] * cores[1] * cores[2]))
    for k0 in range(0, n, chunk):
        _, sq, box = _frame(level.shape[1:], zyx[k0:k0 + chunk], radii,
                            cores, g)
        active += int((box & (sq <= g["rad2"])).sum())
    offsets = int(np.prod([2 * e + 1 for e in table_extents(radii, cores)]))
    ops32 = active * OPS32_VOXEL + (offsets * OPS32_OFFSET if n else 0)
    return nbytes, ops32, active * OPS64_VOXEL, active


def orient_work_levels(rows, levels) -> tuple[int, int, int, int]:
    """``orient_work`` summed over the levels of one
    ``orient_terms_levels`` call (its arguments). Levels that share a
    tensor (the raw-image path's buckets all read one smoothed image) read
    the union of all their windows once."""
    tot, r0, masks = (0, 0, 0, 0), 0, {}
    for level, n, count, *geom in levels:
        r = rows[r0:r0 + n]
        w = orient_work(level, r[:, 1:], count, *geom, vol=r[:, 0],
                        masks=masks)
        tot = tuple(a + b for a, b in zip(tot, w))
        r0 += n
    return tot
