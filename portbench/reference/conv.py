"""Separable convolution in physical (mm) units, dense form only.

A frozen copy of the port's ``ops/conv.py`` less its framed form: each
1-D pass is the banded n x n matrix of the original's FIR filter with
1-D linear interpolation at fractional voxel positions and mirrored
boundaries (imutil.c:2274-2393, apply_Sep_FIR_filter imutil.c:3459-3544),
applied as one fp32 matmul per axis in x, y, z order. TF32 is whatever
``torch.backends.cuda.matmul.allow_tf32`` says: the reference sets it
off, the lower-precision control on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import CONV_EPS


@functools.lru_cache(maxsize=None)
def _conv_matrix_cached(taps_key, unit: float, unit_dim: float, n: int) -> np.ndarray:
    taps = np.asarray(taps_key, dtype=np.float32)
    return _make_conv_matrix(taps, unit, unit_dim, n)


def conv_matrix(taps: np.ndarray, unit: float, unit_dim: float, n: int) -> np.ndarray:
    """Banded convolution matrix W (n x n, float32): out = W @ signal.

    Args:
      taps: float32 filter taps, odd length 2*hw+1.
      unit: physical spacing of the filter taps (mm).
      unit_dim: physical voxel spacing of the image along this axis (mm).
      n: axis length.
    """
    return _conv_matrix_cached(tuple(np.asarray(taps, np.float32).tolist()),
                               float(unit), float(unit_dim), int(n))


def _make_conv_matrix(taps: np.ndarray, unit: float, unit_dim: float,
                      n: int) -> np.ndarray:
    hw = (len(taps) - 1) // 2
    # unit_factor is computed in float32 in the reference (imutil.c:2286-2287)
    uf = np.float32(unit / unit_dim)
    dim_end = n - 1
    d = np.arange(-hw, hw + 1, dtype=np.float32)
    step = d * uf                                    # float32, like the C code
    x = np.arange(n, dtype=np.float32)
    coords = x[:, None] - step[None, :]              # (n, ntaps), float32

    # Mirror boundaries exactly as convolve_sep_gen's second pass
    # (imutil.c:2375-2382). Conditions use truncation toward zero.
    lo0 = np.trunc(coords).astype(np.int64)
    neg = lo0 < 0
    coords = np.where(neg, (-coords).astype(np.float32), coords)
    hi = np.logical_and(~neg, np.trunc(coords).astype(np.int64) >= dim_end)
    coords = np.where(
        hi,
        (np.float32(2.0 * dim_end) - coords - np.float32(CONV_EPS)).astype(np.float32),
        coords)

    lo = np.trunc(coords).astype(np.int64)
    frac = (coords - lo.astype(np.float32)).astype(np.float32)
    # Clamp for safety (the reference reads out of bounds here; only reachable
    # for filters wider than the image, which the pyramid geometry forbids).
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(lo + 1, 0, n - 1)

    W = np.zeros((n, n), dtype=np.float64)
    rows = np.repeat(np.arange(n), len(taps))
    t64 = taps.astype(np.float64)[None, :] * np.ones((n, 1))
    np.add.at(W, (rows, lo_c.ravel()),
              (t64 * (1.0 - frac.astype(np.float64))).ravel())
    np.add.at(W, (rows, hi_c.ravel()),
              (t64 * frac.astype(np.float64)).ravel())
    return W.astype(np.float32)


def conv_axis(vol: torch.Tensor, W, axis: int) -> torch.Tensor:
    """Apply a 1-D operator along ``axis`` of ``vol``:
    out[..., i, ...] = sum_j W[i, j] vol[..., j, ...], one fp32 matmul.
    ``W`` is (n_out, n) for an axis of length n: square for a blur,
    rectangular for a sharded block or a composed pyramid operator."""
    W = torch.as_tensor(W, dtype=vol.dtype, device=vol.device)
    axis = axis % vol.ndim
    if axis == vol.ndim - 1:
        return torch.matmul(vol, W.T)
    shape = vol.shape
    n = shape[axis]
    lead = int(np.prod(shape[:axis], dtype=np.int64))
    v = vol.reshape(lead, n, -1)
    return torch.matmul(W, v).reshape(shape[:axis] + (W.shape[0],) +
                                      shape[axis + 1:])


def conv_sep(vol: torch.Tensor, taps: np.ndarray, unit: float,
             units: tuple[float, float, float]) -> torch.Tensor:
    """Full separable pass over a (z, y, x)-ordered volume or batch, x
    then y then z (imutil.c:3494-3526); ``units`` is (ux, uy, uz)."""
    dims = (vol.ndim - 1, vol.ndim - 2, vol.ndim - 3)
    for axis, u in zip(dims, units):
        n = vol.shape[axis]
        vol = conv_axis(vol, conv_matrix(taps, unit, u, n), axis)
    return vol
