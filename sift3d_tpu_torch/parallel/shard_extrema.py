"""Spatially-sharded DoG extrema detection.

The port of ``sift3d_tpu/parallel/shard_extrema.py``. Each rank detects
extrema on its own slab of the sharded spatial axis with a 1-plane halo of
the current DoG level (the 6-neighbourhood needs +-1 along every axis; the
previous and next levels give only their centre voxels, reference
sift.c:1138-1150). The per-volume DoG max, the relative threshold's
normaliser (sift.c:1162-1169), is an ``all_reduce(MAX)`` over the axis.
The slabs' scan-order rows meet in an ``all_gather`` and a re-reduction
on global scan keys.

Any spatial axis can shard: the merge is on *global* scan-order keys, and
every globally-first extremum is also locally-first within its own slab,
so the result is bit-identical to ``features.extrema.level_extrema`` on
the whole volume whichever axis was sliced.
"""

from __future__ import annotations

import torch

from ..features.extrema import extrema_mask
from .mesh import Mesh, all_gather, pmax, psum
from .shard_conv import DIMS, shard_halo


def level_extrema_sharded(prev: torch.Tensor, cur: torch.Tensor,
                          nxt: torch.Tensor, peak_thresh: float,
                          capacity: int, mesh: Mesh,
                          axis_name: str = "space", shard_dim: str = "z"):
    """Spatially-sharded ``features.extrema.level_extrema`` of a batch.

    Args:
      prev, cur, nxt: this rank's (B, nz, ny, nx) blocks of DoG levels
        s-1, s, s+1: its slab of the ``shard_dim`` axis.
      capacity: max keypoints per volume.

    Returns (rows, count, total) as ``level_extrema`` gives them for the
    rank's B volumes on the whole level, the same on every rank of the
    axis: rows (n, 4) int32 (volume, z, y, x) holding each volume's first
    ``capacity`` extrema in scan order, count and total (B,) (total is the
    unclamped number; total > capacity means rows were dropped).
    """
    sd = DIMS[shard_dim]
    B = cur.shape[0]
    S = cur.shape[1 + sd]
    n3 = list(cur.shape[1:])
    n3[sd] *= mesh.size(axis_name)
    a0 = mesh.index(axis_name) * S
    dev = cur.device
    dogmax = pmax(torch.amax(torch.abs(cur), dim=(1, 2, 3)), mesh,
                  axis_name)

    # Every local row of the sharded axis, as the centre of a slab that
    # carries its +-1 halo planes; the other axes keep their interior.
    cur_h = shard_halo(cur, 1, mesh, 1 + sd, axis_name)
    prev_h = torch.nn.functional.pad(prev, _pad(sd))
    nxt_h = torch.nn.functional.pad(nxt, _pad(sd))
    mask = extrema_mask(prev_h, cur_h, nxt_h, peak_thresh, dogmax=dogmax)
    g = a0 + torch.arange(S, device=dev)
    inner = [1, 1, 1]
    inner[sd] = S
    mask &= ((g >= 1) & (g <= n3[sd] - 2)).reshape(inner)

    # Global scan-order keys of the slab's hits (z-major, like the
    # reference's scan), each volume's first `capacity` of them.
    rows = torch.nonzero(mask)                   # local scan order
    zyx = rows[:, 1:] + 1
    zyx[:, sd] += a0 - 1
    key = ((zyx[:, 0] - 1) * (n3[1] - 2) + (zyx[:, 1] - 1)) * (n3[2] - 2) \
        + (zyx[:, 2] - 1)
    count_l = torch.bincount(rows[:, 0], minlength=B)
    pos = torch.arange(rows.shape[0], device=dev) - \
        (torch.cumsum(count_l, 0) - count_l)[rows[:, 0]]
    keep = pos < capacity
    n_glob = (n3[0] - 2) * (n3[1] - 2) * (n3[2] - 2)
    keys = torch.full((B, capacity), n_glob, dtype=torch.long, device=dev)
    keys[rows[keep, 0], pos[keep]] = key[keep]

    # Merge the slabs: the global first `capacity` keys of each volume.
    g_keys = all_gather(keys, mesh, axis_name)           # (S, B, C)
    merged = torch.sort(g_keys.permute(1, 0, 2).reshape(B, -1), dim=1
                        ).values[:, :capacity]
    total = psum(count_l, mesh, axis_name)
    count = torch.clamp(total, max=capacity)
    hit = torch.nonzero(merged < n_glob)                 # (volume, k)
    k = merged[hit[:, 0], hit[:, 1]]
    ny_i, nx_i = n3[1] - 2, n3[2] - 2
    out = torch.stack([hit[:, 0], k // (ny_i * nx_i) + 1,
                       (k // nx_i) % ny_i + 1, k % nx_i + 1], -1)
    return out.to(torch.int32), count, total


def _pad(sd: int):
    """``F.pad`` widths adding one zero plane on both sides of spatial
    axis ``sd`` of a (B, nz, ny, nx) tensor (last axis first)."""
    pad = [0] * 6
    pad[2 * (2 - sd)] = pad[2 * (2 - sd) + 1] = 1
    return pad
