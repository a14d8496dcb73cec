"""DoG extrema detection.

Reproduces detect_extrema (reference sift3d/sift.c:1074-1212), as
``sift3d_tpu/features/extrema.py`` does: per DoG level, a voxel at
(x, y, z) in [1, n-2]^3 is a keypoint candidate iff

  - |value| strictly exceeds peak_thresh * max|level|, and
  - it is a strict maximum (or strict minimum) over its 6-neighborhood in the
    current level plus the center voxels of the previous and next levels
    (the default non-CUBOID_EXTREMA comparison set, sift.c:1138-1150).

Candidates come out in the reference's scan order (z, then y, then x;
immacros.h:66-69): ``torch.nonzero`` of the mask is already in that order,
and for a (B, nz, ny, nx) batch in (volume, z, y, x) order. Each volume is
held to its own max |DoG| (``jax.vmap(level_extrema)`` in
``sift3d_tpu/parallel/pipeline.py``).

``extrema_levels`` finds the extrema of every keypoint level of a
detection with one host read: on the card by the kernels of
``ops/cuda_extrema.py``, elsewhere by the plain version here
(``extrema_mask``, a capacity cap by cumsum and ``torch.nonzero``), which
the kernels' tests hold them to.
"""

from __future__ import annotations

import torch

from ..ops import cuda_extrema
from ..utils import trace


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


def _scan_plain(levels, peak_thresh: float):
    """``ops/cuda_extrema.scan``'s plain version: ``extrema_mask`` of each
    level, each volume's first ``capacity`` hits by a cumsum over the
    level, and ``torch.nonzero``."""
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


def extrema_levels(levels, peak_thresh: float):
    """Find the extrema of many DoG levels, of one volume or of a batch,
    with one host read.

    Args:
      levels: per level, (prev, cur, nxt, capacity): DoG levels s-1, s,
        s+1, each (nz, ny, nx) or (B, nz, ny, nx) (one form and one B for
        every level), and the max keypoints kept per volume.
      peak_thresh: relative threshold.

    Returns, per level, ``level_extrema``'s (rows, count, total). Batch
    rows are slices of one (n, 4) buffer, level by level. CUDA tensors go
    through the kernels of ``ops/cuda_extrema.py`` and CPU tensors through
    ``_scan_plain``; either way the counts come to the host in one read,
    in the span ``sift3d.sync.extrema``.
    """
    if not levels:
        return []
    single = levels[0][1].ndim == 3
    if single:
        levels = [(p[None], c[None], n[None], cap)
                  for p, c, n, cap in levels]
    dev = levels[0][1].device
    if dev.type == "cuda":
        count, total, emit = cuda_extrema.scan(levels, peak_thresh)
        trace.count("extrema.kernel_levels", len(levels))
    elif dev.type == "cpu":
        count, total, emit = _scan_plain(levels, peak_thresh)
    else:
        raise ValueError(f"extrema_levels: unsupported device {dev}")
    with trace.host_read("extrema"):
        host = torch.stack([count, total]).cpu()
    sizes = host[0].sum(1).tolist()
    rows = emit(sum(sizes))
    trace.count("extrema.levels", len(levels))
    trace.count("extrema.rows", rows.shape[0])
    out, r0 = [], 0
    for l, n in enumerate(sizes):
        r = rows[r0:r0 + n]
        r0 += n
        if single:
            out.append((r[:, 1:], int(host[0, l, 0]), int(host[1, l, 0])))
        else:
            out.append((r, count[l], total[l]))
    return out


def level_extrema(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                  peak_thresh: float, capacity: int):
    """Find extrema on one DoG level, of one volume or of a batch
    (``extrema_levels`` of one level).

    Args:
      prev, cur, nxt: DoG levels s-1, s, s+1, each (nz, ny, nx) or
        (B, nz, ny, nx).
      peak_thresh: relative threshold.
      capacity: max keypoints returned per volume.

    Returns (zyx, count, total). For one volume: zyx (count, 3) int32
    voxel coords in scan order, count = min(total, capacity) and total, the
    unclamped number of extrema on the level (total > capacity means rows
    were dropped), as ints. For a batch: rows (n, 4) int32 (volume, z, y,
    x) holding each volume's first ``capacity`` extrema in scan order, and
    count and total as (B,) tensors. One host sync either way, in the
    span ``sift3d.sync.extrema``.
    """
    return extrema_levels([(prev, cur, nxt, capacity)], peak_thresh)[0]
