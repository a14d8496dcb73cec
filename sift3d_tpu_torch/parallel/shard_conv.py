"""Spatially-sharded separable convolution with halo exchange.

The port of ``sift3d_tpu/parallel/shard_conv.py``. A volume is split along
one spatial axis over the mesh axis "space". The two other passes of the
separable convolution are local to each rank (full-width matmuls,
``ops/conv.conv_axis``). The sharded pass needs out-of-slab voxels: each
rank exchanges an H-voxel halo slab with its neighbours
(``batch_isend_irecv``), then applies its block of the global convolution
matrix, one ``torch.matmul`` as the JAX package leaves it to XLA.

Correctness is exact, not approximate: the global banded matrix W (which
encodes the reference's mm-unit interpolated taps and mirror boundary,
imutil.c:2274-2393) is sliced per rank into W[rows_s, cols in window_s].
H is the true maximum band spread of W, so every nonzero column of a
rank's rows is covered by [local - H, local + H]. Out-of-volume window
columns are structurally zero in W, which is why the edge ranks take
zero-filled halos.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import conv
from .mesh import Mesh, exchange

DIMS = {"z": 0, "y": 1, "x": 2}


def band_halo(taps, unit: float, unit_dim: float, n: int) -> int:
    """H: the largest |column - row| of a nonzero of the n x n matrix."""
    W = conv.conv_matrix(np.asarray(taps, np.float32), unit, unit_dim, n)
    rows, cols = np.nonzero(W)
    return int(np.max(np.abs(cols - rows))) if len(rows) else 0


@functools.lru_cache(maxsize=None)
def _block_matrices(taps_key, unit: float, unit_dim: float, n: int,
                    n_shards: int):
    """Per-shard matrix blocks: (S, L, L + 2H) float32, plus H."""
    taps = np.asarray(taps_key, np.float32)
    W = conv.conv_matrix(taps, unit, unit_dim, n)        # (n, n)
    H = band_halo(taps, unit, unit_dim, n)
    L = n // n_shards
    if L * n_shards != n:
        raise ValueError(f"extent {n} not divisible by {n_shards} shards")
    if H > L:
        raise ValueError(f"halo {H} exceeds shard length {L}; use fewer "
                         f"spatial shards for this volume")
    Wp = np.zeros((n, n + 2 * H), np.float32)
    Wp[:, H:H + n] = W
    blocks = np.stack([Wp[s * L:(s + 1) * L, s * L:s * L + L + 2 * H]
                       for s in range(n_shards)])
    return blocks, H


def _take(x: torch.Tensor, dim: int, start: int, stop: int | None):
    return x.narrow(dim, start, (x.shape[dim] if stop is None else stop)
                    - start)


def shard_halo(x_local: torch.Tensor, H: int, mesh: Mesh, dim: int,
               axis_name: str = "space") -> torch.Tensor:
    """Extend this rank's block by H planes on both sides of ``dim`` with
    its neighbours' edge planes along ``axis_name``; the global edges are
    zero-filled (JAX's unpaired ``ppermute`` sends drop)."""
    n_sh = mesh.size(axis_name)
    pad_shape = list(x_local.shape)
    pad_shape[dim] = H
    lo = x_local.new_zeros(pad_shape)
    hi = x_local.new_zeros(pad_shape)
    if H and n_sh > 1:
        i = mesh.index(axis_name)
        n = x_local.shape[dim]
        sends, recvs = [], []
        if i + 1 < n_sh:        # my last planes are my upper neighbour's lo
            sends.append((_take(x_local, dim, n - H, None).contiguous(),
                          i + 1, 0))
            recvs.append((hi, i + 1, 1))
        if i > 0:               # my first planes are my lower neighbour's hi
            sends.append((_take(x_local, dim, 0, H).contiguous(), i - 1, 1))
            recvs.append((lo, i - 1, 0))
        exchange(sends, recvs, mesh, axis_name)
    return torch.cat([lo, x_local, hi], dim=dim)


def conv_sep_sharded(vol: torch.Tensor, taps: np.ndarray, unit: float,
                     units: tuple[float, float, float], mesh: Mesh,
                     axis_name: str = "space",
                     shard_dim: str = "z") -> torch.Tensor:
    """Separable mm-unit convolution of a spatially-sharded volume.

    Args:
      vol: this rank's block, (nz, ny, nx) or (B, nz, ny, nx), holding its
        slab of the ``shard_dim`` axis ("z", "y" or "x"; the global extent
        is the slab's times the size of ``axis_name``).
      taps, unit, units: as ``ops.conv.conv_sep``.

    Returns this rank's block of the convolved volume. The sharded axis is
    applied last, so for "y" / "x" the pass order differs from the
    reference's x-y-z (equal up to fp32 rounding: the passes commute);
    bit-parity paths use "z".
    """
    sd = DIMS[shard_dim]
    off = vol.ndim - 3
    n3 = list(vol.shape[-3:])
    n_shards = mesh.size(axis_name)
    n3[sd] *= n_shards                       # global extents, zyx
    u3 = (units[2], units[1], units[0])      # per-dim units, zyx order
    taps_key = tuple(np.asarray(taps, np.float32).tolist())
    blocks, H = _block_matrices(taps_key, float(unit), float(u3[sd]),
                                n3[sd], n_shards)
    x = vol
    for d in (2, 1, 0):                      # reference order: x, y, z
        if d != sd:
            x = conv.conv_axis(x, conv.conv_matrix(taps, unit, u3[d], n3[d]),
                               off + d)
    xext = shard_halo(x, H, mesh, off + sd, axis_name)
    return conv.conv_axis(xext, blocks[mesh.index(axis_name)], off + sd)
