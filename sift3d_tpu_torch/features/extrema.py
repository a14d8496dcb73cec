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
detection with one host read, through ``ops/cuda_extrema.scan`` (the
kernels on the card, their plain version ``scan_plain`` on the CPU);
``extrema_mask``, the test itself, lives there too.
"""

from __future__ import annotations

import torch

from ..ops import cuda_extrema
from ..ops.cuda_extrema import extrema_mask  # noqa: F401  (re-exported)
from ..utils import trace


def extrema_levels(levels, peak_thresh: float):
    """Find the extrema of many DoG levels, of one volume or of a batch,
    with one host read.

    Args:
      levels: per level, (prev, cur, nxt, capacity): DoG levels s-1, s,
        s+1, each (nz, ny, nx) or (B, nz, ny, nx) (one form and one B for
        every level), and the max keypoints kept per volume.
      peak_thresh: relative threshold.

    Returns, per level, ``level_extrema``'s (rows, count, total). Batch
    rows are slices of one (n, 4) buffer, level by level. The counts of
    ``cuda_extrema.scan`` come to the host in one read, in the span
    ``sift3d.sync.extrema``.
    """
    if not levels:
        return []
    single = levels[0][1].ndim == 3
    if single:
        levels = [(p[None], c[None], n[None], cap)
                  for p, c, n, cap in levels]
    count, total, emit = cuda_extrema.scan(levels, peak_thresh)
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
