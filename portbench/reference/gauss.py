"""Gaussian filter bank construction (numpy; a copy of
``sift3d_tpu/ops/gauss.py``).

Reproduces the reference's truncated, sum-normalized sampled Gaussians with
float32 arithmetic (reference imutil.c:3649-3734). The taps feed the
banded convolution matrices in ops/conv.py.
"""

from __future__ import annotations

import math

import numpy as np

from .config import GAUSS_WIDTH_FCTR

_DBL_EPSILON = 2.220446049250313e-16


def gauss_taps(sigma: float) -> np.ndarray:
    """Normalized Gaussian taps, float32, width 2*ceil(3*sigma)+1.

    Matches init_Gauss_filter (imutil.c:3657-3710): taps computed in double,
    cast to float, then normalized by the float32 running sum.
    """
    half_width = max(int(math.ceil(sigma * GAUSS_WIDTH_FCTR)), 1) if sigma > 0 else 1
    width = 2 * half_width + 1
    kernel = np.empty(width, dtype=np.float32)
    acc = np.float32(0)
    for i in range(width):
        x = (float(i) - half_width) / (sigma + _DBL_EPSILON)
        kernel[i] = np.float32(math.exp(-0.5 * x * x))
        acc = np.float32(acc + kernel[i])
    return kernel / acc


def incremental_sigma(s_cur: float, s_next: float) -> float:
    """Sigma of the filter taking scale s_cur to s_next (imutil.c:3713-3734)."""
    if s_cur > s_next:
        raise ValueError(f"s_cur ({s_cur}) > s_next ({s_next})")
    return math.sqrt(s_next * s_next - s_cur * s_cur)


def incremental_taps(s_cur: float, s_next: float) -> np.ndarray:
    """Taps of the filter taking scale s_cur to s_next."""
    return gauss_taps(incremental_sigma(s_cur, s_next))
