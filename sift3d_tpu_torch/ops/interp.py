"""Image warping and resampling.

Reproduces im_inv_transform / resample_linear / resample_lanczos2 /
im_resample (reference imutil/imutil.c:2040-2244), as
``sift3d_tpu/ops/interp.py`` does:

- pull-warp: for every output voxel (x, y, z), apply the affine to get a
  source coordinate and sample the source image there;
- trilinear sampling uses floor/ceil corners and returns 0 outside
  [0, n-1] in any dimension (imutil.c:2085-2124);
- Lanczos-2 sampling evaluates the unnormalized kernel over the window
  [floor(p)-2, floor(p)+2] clamped to the volume (out-of-range taps are
  skipped, not clamped), with DBL_EPSILON added to |dx| before the kernel
  (imutil.c:2127-2180);
- im_resample maps to new physical units via the diagonal affine
  diag(units_new / units_old) with output dims ceil(n * old / new)
  (imutil.c:2191-2244).

Coordinates, weights and sums are float64, as the JAX package's ``f64()``
arithmetic; the result has the source's dtype. This is dense gather
arithmetic with no kernel of its own: plain torch operations on the
source's device. The output grid is taken a z-slab at a time (at most
``SLAB_VOXELS`` output voxels), so a 256^3 warp never holds the whole
float64 coordinate grid; every voxel's arithmetic is the same either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..dtypes import F64

_DBL_EPSILON = 2.220446049250313e-16
# Output voxels per slab of ``im_inv_transform``.
SLAB_VOXELS = 1 << 22


def apply_affine_grid(A, shape_zyx, z0: int = 0, z1: int | None = None,
                      device=None):
    """Transformed coordinates of the output planes [z0, z1) of a grid.

    Returns (xs, ys, zs), each (z1 - z0, ny, nx) float64: A @ [x; y; z; 1].
    """
    nz, ny, nx = shape_zyx
    z1 = nz if z1 is None else z1
    A = (A if torch.is_tensor(A) else torch.as_tensor(
        np.array(A, np.float64))).to(device=device, dtype=F64)
    dev = A.device
    x = torch.arange(nx, dtype=F64, device=dev)[None, None, :]
    y = torch.arange(ny, dtype=F64, device=dev)[None, :, None]
    z = torch.arange(z0, z1, dtype=F64, device=dev)[:, None, None]
    xs = A[0, 0] * x + A[0, 1] * y + A[0, 2] * z + A[0, 3]
    ys = A[1, 0] * x + A[1, 1] * y + A[1, 2] * z + A[1, 3]
    zs = A[2, 0] * x + A[2, 1] * y + A[2, 2] * z + A[2, 3]
    return xs, ys, zs


def _in_bounds(src, xs, ys, zs):
    nz, ny, nx = src.shape
    return ((xs >= 0) & (xs <= nx - 1) & (ys >= 0) & (ys <= ny - 1) &
            (zs >= 0) & (zs <= nz - 1))


def _at(src, zz, yy, xx):
    """src[zz, yy, xx] as float64, by flat index."""
    _, ny, nx = src.shape
    return torch.take(src, (zz * ny + yy) * nx + xx).to(F64)


def sample_linear(src: torch.Tensor, xs, ys, zs) -> torch.Tensor:
    """Trilinear sampling with out-of-bounds -> 0 (imutil.c:2085-2124)."""
    inb = _in_bounds(src, xs, ys, zs)
    zero = torch.zeros((), dtype=F64, device=xs.device)
    xs = torch.where(inb, xs, zero)
    ys = torch.where(inb, ys, zero)
    zs = torch.where(inb, zs, zero)

    fx, fy, fz = torch.floor(xs), torch.floor(ys), torch.floor(zs)
    cx, cy, cz = (torch.ceil(c).long() for c in (xs, ys, zs))
    dx, dy, dz = xs - fx, ys - fy, zs - fz
    fx, fy, fz = fx.long(), fy.long(), fz.long()

    out = (_at(src, fz, fy, fx) * (1 - dx) * (1 - dy) * (1 - dz)
           + _at(src, fz, cy, fx) * (1 - dx) * dy * (1 - dz)
           + _at(src, fz, fy, cx) * dx * (1 - dy) * (1 - dz)
           + _at(src, fz, cy, cx) * dx * dy * (1 - dz)
           + _at(src, cz, fy, fx) * (1 - dx) * (1 - dy) * dz
           + _at(src, cz, cy, fx) * (1 - dx) * dy * dz
           + _at(src, cz, fy, cx) * dx * (1 - dy) * dz
           + _at(src, cz, cy, cx) * dx * dy * dz)
    return torch.where(inb, out, zero).to(src.dtype)


def _lanczos(x, a: float):
    """Unnormalized Lanczos kernel (imutil.c:2183-2187); x > 0."""
    pi_x = math.pi * x
    return a * torch.sin(pi_x) * torch.sin(pi_x / a) / (pi_x * pi_x)


def sample_lanczos2(src: torch.Tensor, xs, ys, zs) -> torch.Tensor:
    """Lanczos-2 sampling with out-of-bounds -> 0 (imutil.c:2127-2180)."""
    a = 2
    nz, ny, nx = src.shape
    inb = _in_bounds(src, xs, ys, zs)
    zero = torch.zeros((), dtype=F64, device=xs.device)
    xs_s = torch.where(inb, xs, zero)
    ys_s = torch.where(inb, ys, zero)
    zs_s = torch.where(inb, zs, zero)
    offs = range(-a, a + 1)

    def axis_taps(p, n):
        """Per-offset (clamped index, masked kernel weight) along one axis."""
        f = torch.floor(p).long()
        idxs, ws = [], []
        for o in offs:
            i = f + o
            m = (i >= 0) & (i <= n - 1)
            ic = torch.clamp(i, 0, n - 1)
            w = _lanczos(torch.abs(ic.to(F64) - p) + _DBL_EPSILON, a)
            idxs.append(ic)
            ws.append(torch.where(m, w, zero))
        return idxs, ws

    xi, xw = axis_taps(xs_s, nx)
    yi, yw = axis_taps(ys_s, ny)
    zi, zw = axis_taps(zs_s, nz)
    out = torch.zeros(xs.shape, dtype=F64, device=xs.device)
    for iz in range(len(offs)):
        for iy in range(len(offs)):
            wzy = zw[iz] * yw[iy]
            for ix in range(len(offs)):
                out = out + wzy * xw[ix] * _at(src, zi[iz], yi[iy], xi[ix])
    return torch.where(inb, out, zero).to(src.dtype)


_SAMPLERS = {"linear": sample_linear, "lanczos2": sample_lanczos2}


def im_inv_transform(A, src: torch.Tensor, out_shape_zyx=None,
                     interp: str = "linear") -> torch.Tensor:
    """Pull-warp ``src`` (nz, ny, nx) through the (3, 4) affine ``A``
    (im_inv_transform, imutil.c:2040-2081). ``A`` maps output (x, y, z)
    to source coordinates. Runs on ``src``'s device."""
    sampler = _SAMPLERS[interp]
    if out_shape_zyx is None:
        out_shape_zyx = tuple(src.shape)
    nz, ny, nx = (int(n) for n in out_shape_zyx)
    src = src.contiguous()
    out = torch.empty((nz, ny, nx), dtype=src.dtype, device=src.device)
    planes = max(1, SLAB_VOXELS // max(1, ny * nx))
    for z0 in range(0, nz, planes):
        z1 = min(nz, z0 + planes)
        xs, ys, zs = apply_affine_grid(A, (nz, ny, nx), z0, z1, src.device)
        out[z0:z1] = sampler(src, xs, ys, zs)
    return out


def resample_dims(dims_zyx, units_old, units_new):
    """Output dims for im_resample: ceil(n * old_unit / new_unit) per axis.

    dims are (nz, ny, nx); units are (ux, uy, uz) - note reversed order.
    """
    nz, ny, nx = dims_zyx
    fx = units_old[0] / units_new[0]
    fy = units_old[1] / units_new[1]
    fz = units_old[2] / units_new[2]
    return (int(math.ceil(nz * fz)), int(math.ceil(ny * fy)),
            int(math.ceil(nx * fx)))


def im_resample(src: torch.Tensor, units_old, units_new,
                interp: str = "linear") -> torch.Tensor:
    """Resample to new physical units (im_resample, imutil.c:2191-2244)."""
    out_shape = resample_dims(src.shape, units_old, units_new)
    A = np.array([
        [units_new[0] / units_old[0], 0, 0, 0],
        [0, units_new[1] / units_old[1], 0, 0],
        [0, 0, units_new[2] / units_old[2], 0]], dtype=np.float64)
    return im_inv_transform(A, src, out_shape, interp)
