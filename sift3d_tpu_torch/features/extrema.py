"""DoG extrema detection.

Reproduces detect_extrema (reference sift3d/sift.c:1074-1212), as
``sift3d_tpu/features/extrema.py`` does: per DoG level, a voxel at
(x, y, z) in [1, n-2]^3 is a keypoint candidate iff

  - |value| strictly exceeds peak_thresh * max|level|, and
  - it is a strict maximum (or strict minimum) over its 6-neighborhood in the
    current level plus the center voxels of the previous and next levels
    (the default non-CUBOID_EXTREMA comparison set, sift.c:1138-1150).

Candidates come out in the reference's scan order (z, then y, then x;
immacros.h:66-69): ``torch.nonzero`` of the flattened mask is already in
that order.
"""

from __future__ import annotations

import torch


def level_extrema(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                  peak_thresh: float, capacity: int):
    """Find extrema on one DoG level.

    Args:
      prev, cur, nxt: (nz, ny, nx) DoG levels s-1, s, s+1.
      peak_thresh: relative threshold.
      capacity: max keypoints returned.

    Returns:
      (zyx, count, total): zyx (count, 3) int32 voxel coords in scan order,
      count = min(total, capacity), and total, the unclamped number of
      extrema on the level (total > capacity means rows were dropped).
    """
    dogmax = torch.max(torch.abs(cur))
    t = torch.as_tensor(peak_thresh, dtype=cur.dtype) * dogmax

    c = cur[1:-1, 1:-1, 1:-1]
    peak_ok = (c > t) | (c < -t)
    p_c = prev[1:-1, 1:-1, 1:-1]
    n_c = nxt[1:-1, 1:-1, 1:-1]
    is_max = (c > p_c) & (c > n_c)
    is_min = (c < p_c) & (c < n_c)
    for nb in (cur[1:-1, 1:-1, 2:], cur[1:-1, 1:-1, :-2],
               cur[1:-1, 2:, 1:-1], cur[1:-1, :-2, 1:-1],
               cur[:-2, 1:-1, 1:-1], cur[2:, 1:-1, 1:-1]):
        is_max &= c > nb
        is_min &= c < nb
    mask = peak_ok & (is_max | is_min)

    flat = torch.nonzero(mask.reshape(-1)).reshape(-1)   # one host sync
    total = int(flat.numel())
    count = min(total, capacity)
    flat = flat[:count]
    inner_ny, inner_nx = cur.shape[1] - 2, cur.shape[2] - 2
    zz = flat // (inner_ny * inner_nx) + 1
    yy = (flat // inner_nx) % inner_ny + 1
    xx = flat % inner_nx + 1
    zyx = torch.stack([zz, yy, xx], dim=-1).to(torch.int32)
    return zyx, count, total
