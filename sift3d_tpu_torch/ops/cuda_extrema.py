"""DoG extrema: the CUDA kernels (``csrc/extrema_scan.cu``) of every
keypoint level of a detection at once, and their plain PyTorch version.

``scan`` launches the kernels for CUDA tensors and runs ``scan_plain``
(``extrema_mask`` of each level, a capacity cap by cumsum and
``torch.nonzero``) for CPU tensors; there is no fallback. The glue both
share (``features/extrema.extrema_levels``: the one host read and the
per-level slices) calls ``scan``. For a (B, nz, ny, nx) batch the
kernels take, per level, each volume's max |cur| (max pass), the hits of
``extrema_mask``'s test in each block of whole interior rows (count pass;
no mask is written), and, after the read, write each volume's first
``capacity`` hits in scan order as (volume, z, y, x) rows (emit pass),
the rows the plain version's ``torch.nonzero`` gives, bit for bit: the
threshold is the same fp32 product and the comparisons are the same.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils import trace

# The kernels' limits: levels a launch (its parameter table; more levels
# take more launches), warps of a count / emit block, values of one
# volume a max-pass block reduces (the source's kMaxValues).
MAX_LEVELS = 32
WARPS = 8
MAX_BLOCK_VALUES = 4096
# Interior voxels a count / emit block aims at (whole rows, a multiple of
# WARPS of them).
BLOCK_VOXELS = 4096


class _Level(ctypes.Structure):
    """The kernels' ``Sift3dExtremaLevel`` (``csrc/extrema_scan.cu``)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("prev", "cur", "next")] +
                [(f, ctypes.c_int) for f in (
                    "nz", "ny", "nx", "rows", "rows_per_block", "chunks",
                    "block0", "max_chunks", "max_block0", "seg0",
                    "capacity")] +
                [("gblock0", ctypes.c_longlong)])


def rows_per_block(nx: int) -> int:
    """Interior rows of a count / emit block of a level nx voxels wide: a
    multiple of WARPS (a warp walks a row), near BLOCK_VOXELS voxels."""
    return WARPS * max(1, round(BLOCK_VOXELS / (WARPS * (nx - 2))))


def _fn(name: str, n_ptrs: int, peak: bool):
    fn = getattr(_build.load("extrema_scan"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P, I, I] + ([ctypes.c_float] if peak else []) +
                       [P] * n_ptrs + [P])
        fn.restype = ctypes.c_int
    return fn


def _groups(entries):
    """The launches of each pass: (table, levels, count / emit blocks,
    max-pass blocks) for each group of at most MAX_LEVELS entries, with
    each entry's first blocks in its launch (``block0``, ``max_block0``)
    set."""
    out = []
    for j in range(0, len(entries), MAX_LEVELS):
        group = entries[j:j + MAX_LEVELS]
        table = (_Level * len(group))(*(lv for lv, _, _ in group))
        blocks = max_blocks = 0
        for e, (_, n, n_max) in zip(table, group):
            e.block0, e.max_block0 = blocks, max_blocks
            blocks += n
            max_blocks += n_max
        out.append((table, len(group), blocks, max_blocks))
    return out


def extrema_mask(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                 peak_thresh: float,
                 dogmax: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nz-2, ny-2, nx-2) bool: the interior voxels of ``cur`` that
    are extrema, each volume against its own max |value| (or the given
    per-volume ``dogmax``, when ``cur`` is a slab of the volume)."""
    if dogmax is None:
        dogmax = torch.amax(torch.abs(cur), dim=(-3, -2, -1))
    dogmax = dogmax[..., None, None, None]
    t = torch.as_tensor(peak_thresh, dtype=cur.dtype) * dogmax

    c = cur[..., 1:-1, 1:-1, 1:-1]
    peak_ok = (c > t) | (c < -t)
    p_c = prev[..., 1:-1, 1:-1, 1:-1]
    n_c = nxt[..., 1:-1, 1:-1, 1:-1]
    is_max = (c > p_c) & (c > n_c)
    is_min = (c < p_c) & (c < n_c)
    for nb in (cur[..., 1:-1, 1:-1, 2:], cur[..., 1:-1, 1:-1, :-2],
               cur[..., 1:-1, 2:, 1:-1], cur[..., 1:-1, :-2, 1:-1],
               cur[..., :-2, 1:-1, 1:-1], cur[..., 2:, 1:-1, 1:-1]):
        is_max &= c > nb
        is_min &= c < nb
    return peak_ok & (is_max | is_min)


def scan_plain(levels, peak_thresh: float):
    """``scan``'s plain version: ``extrema_mask`` of each level, each
    volume's first ``capacity`` hits by a cumsum over the level, and
    ``torch.nonzero``."""
    rows, count, total = [], [], []
    for prev, cur, nxt, capacity in levels:
        mask = extrema_mask(prev, cur, nxt, peak_thresh)
        flat = mask.reshape(mask.shape[0], -1)
        t = flat.sum(1)
        if capacity < flat.shape[1]:
            # Keep each volume's first `capacity` hits in scan order.
            flat = flat & (torch.cumsum(flat, 1, dtype=torch.int32) <=
                           capacity)
        r = torch.nonzero(flat.reshape(mask.shape)).to(torch.int32)
        r[:, 1:] += 1
        rows.append(r)
        total.append(t)
        count.append(torch.clamp(t, max=capacity))
    return (torch.stack(count), torch.stack(total),
            lambda n: torch.cat(rows))


def scan(levels, peak_thresh: float):
    """Count the extrema of every level and return how to emit them.

    Args:
      levels: per level, (prev, cur, nxt, capacity): (B, nz, ny, nx)
        tensors of DoG levels s - 1, s, s + 1 (float32 on a CUDA device;
        one B and one device for all levels) and the rows kept a volume.
      peak_thresh: the relative threshold.

    Returns (count, total, emit): (levels, B) int64 tensors of the clamped
    and the unclamped extrema counts, and ``emit(n)``, which returns the
    (n, 4) int32 rows (volume, z, y, x) of every level, level by level, n
    the sum of ``count`` read on the host. On the card every launch is
    queued on the current stream (nothing here waits for the card) and
    the levels are counted as ``extrema.kernel_levels``.
    """
    dev = levels[0][1].device
    if dev.type == "cpu":
        return scan_plain(levels, peak_thresh)
    if dev.type != "cuda":
        raise ValueError(f"extrema scan: unsupported device {dev}")
    B = levels[0][1].shape[0]
    L = len(levels)
    held, entries, G = [], [], 0
    for l, (prev, cur, nxt, cap) in enumerate(levels):
        if any(t.device != dev or t.dtype != torch.float32 or t.ndim != 4 or
               t.shape != cur.shape or t.shape[0] != B
               for t in (prev, cur, nxt)):
            raise ValueError("extrema scan: levels must be (B, nz, ny, nx) "
                             "float32 tensors of one shape a level, one B "
                             "and one device")
        nz, ny, nx = cur.shape[1:]
        if nz * ny * nx > 2 ** 31 - 2 * MAX_BLOCK_VALUES:
            raise ValueError(f"extrema scan: a {tuple(cur.shape[1:])} volume "
                             f"exceeds int32 offsets")
        if min(nz, ny, nx) < 3 or B == 0:
            continue               # no interior voxel: no extrema
        prev, cur, nxt = (t.contiguous() for t in (prev, cur, nxt))
        held += [prev, cur, nxt]
        rows = (nz - 2) * (ny - 2)
        rpb = rows_per_block(nx)
        chunks = -(-rows // rpb)
        max_chunks = -(-(nz * ny * nx) // MAX_BLOCK_VALUES)
        lv = _Level(prev.data_ptr(), cur.data_ptr(), nxt.data_ptr(), nz, ny,
                    nx, rows, rpb, chunks, 0, max_chunks, 0, l * B,
                    min(int(cap), 2 ** 31 - 1), G)
        entries.append((lv, B * chunks, B * max_chunks))
        G += B * chunks
    # Per (level, volume): the bits of max |cur|, the unclamped count and
    # the capacity (written by the count pass; 0 where a level has no
    # interior).
    stats = torch.zeros((3, L * B), dtype=torch.int32, device=dev)
    block_counts = torch.empty(G, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    peak = ctypes.c_float(float(np.float32(peak_thresh)))
    groups = _groups(entries)
    max_fn = _fn("sift3d_extrema_max", 1, False)
    for table, n, _, blocks in groups:
        _build.check(max_fn(ctypes.addressof(table), n, blocks,
                            stats[0].data_ptr(), stream),
                     "extrema_scan max launch")
        trace.count("launches.extrema_scan")
    count_fn = _fn("sift3d_extrema_count", 4, True)
    for table, n, blocks, _ in groups:
        _build.check(count_fn(ctypes.addressof(table), n, blocks, peak,
                              stats[0].data_ptr(), stats[1].data_ptr(),
                              stats[2].data_ptr(), block_counts.data_ptr(),
                              stream),
                     "extrema_scan count launch")
        trace.count("launches.extrema_scan")
    count = torch.minimum(stats[1], stats[2])
    before = torch.cumsum(block_counts, 0, dtype=torch.int64) - block_counts
    out_start = torch.cumsum(count, 0, dtype=torch.int64) - count

    def emit(n: int) -> torch.Tensor:
        rows = torch.empty((n, 4), dtype=torch.int32, device=dev)
        if n == 0:
            return rows
        emit_fn = _fn("sift3d_extrema_emit", 5, True)
        for table, k, blocks, _ in groups:
            _build.check(emit_fn(ctypes.addressof(table), k, blocks, peak,
                                 stats[0].data_ptr(),
                                 block_counts.data_ptr(), before.data_ptr(),
                                 out_start.data_ptr(), rows.data_ptr(),
                                 stream),
                         "extrema_scan emit launch")
            trace.count("launches.extrema_scan")
        held.clear()           # the launches are queued
        return rows

    trace.count("extrema.kernel_levels", L)
    return count.view(L, B).long(), stats[1].view(L, B).long(), emit


def _sectors(mask: torch.Tensor) -> int:
    """32-byte sectors of a float32 tensor of ``mask``'s shape that hold a
    True voxel."""
    flat = mask.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % 8))
    return int(flat.view(-1, 8).any(1).sum())


def scan_work(levels, peak_thresh: float) -> tuple[int, ...]:
    """(least bytes, the kernels' bytes, fp32 compares, voxels passing |c|
    > t, rows) of ``scan`` and its emit on these ``levels`` (``scan``'s
    arguments), counted from the levels' values on their device.

    The least bytes are what the function needs: each level's cur read
    once (its max takes every voxel), prev and next read only in the
    32-byte sectors that hold an interior voxel with |c| > t (the test
    looks at them nowhere else; cur's neighbours are cur's own bytes), and
    16 bytes a row written. The kernels' bytes add what this design reads
    again: cur a second time (the count pass follows the max pass), and in
    the blocks the emit pass walks (those with hits whose first rank is
    below the capacity, counted whole) cur's sectors and prev's and
    next's passing sectors once more. Traffic between L2 and the SMs (the
    neighbours' loads) is not counted."""
    least = design = ops = passing = n_rows = 0
    for prev, cur, nxt, cap in levels:
        B, nz, ny, nx = cur.shape
        if min(nz, ny, nx) < 3 or B == 0:
            continue
        dogmax = torch.amax(torch.abs(cur), dim=(-3, -2, -1))
        t = (torch.as_tensor(peak_thresh, dtype=cur.dtype) *
             dogmax)[:, None, None, None]
        c = cur[:, 1:-1, 1:-1, 1:-1]
        ok = torch.zeros(cur.shape, dtype=torch.bool, device=cur.device)
        ok[:, 1:-1, 1:-1, 1:-1] = (c > t) | (c < -t)
        # The emit pass's blocks: runs of rows_per_block interior rows.
        rows = (nz - 2) * (ny - 2)
        rpb = rows_per_block(nx)
        hits = extrema_mask(prev, cur, nxt, peak_thresh).sum(-1).reshape(
            B, rows)
        hits = torch.nn.functional.pad(hits, (0, -rows % rpb))
        block = hits.view(B, -1, rpb).sum(-1)
        before = torch.cumsum(block, 1) - block
        walked = ((block > 0) & (before < int(cap))).repeat_interleave(
            rpb, 1)[:, :rows].reshape(B, nz - 2, ny - 2)
        walk = torch.zeros_like(ok)
        walk[:, 1:-1, 1:-1, 1:-1] = walked[..., None]
        found = int(torch.clamp(hits.sum(1), max=int(cap)).sum())
        s_ok = _sectors(ok)
        least += 4 * cur.numel() + 2 * 32 * s_ok + 16 * found
        design += (2 * 4 * cur.numel() + 2 * 32 * s_ok + 32 * _sectors(walk)
                   + 2 * 32 * _sectors(ok & walk) + 16 * found)
        n_ok = int(ok.sum())
        ops += cur.numel() + 2 * c.numel() + 16 * n_ok
        passing += n_ok
        n_rows += found
    return least, design, ops, passing, n_rows
