"""Thin-plate spline (TPS) transforms, in float64.

The port of ``sift3d_tpu/register/tps.py``. The reference declares a Tps
transform with an implemented apply (apply_Tps_xyz, imutil.c:2676-2729;
kernel U(r^2) = r^2 log(r^2)) but never implemented the fit
(solve_system: "TPS not yet implemented", imutil.c:4507); the JAX package
adds the standard fit and this module repeats it:

    [ K   P ] [ w ]   [ v ]        K_ij = U(|c_i - c_j|^2)
    [ P^T 0 ] [ a ] = [ 0 ],       P    = [1 | c]

with an optional bending-energy term ``reg`` on K's diagonal. Parameters
are stored like the reference's Tps struct (imtypes.h:368-373): params
(3, n_ctrl + 4) with columns [w_0..w_{n-1}, a_const, a_x, a_y, a_z],
control points (n_ctrl, 3). The solve and the warp are dense tensor work
on the tensors' device; no kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from ..dtypes import F64
from ..ops.interp import _SAMPLERS

# Points a chunk of ``im_inv_transform_tps`` holds per control point: its
# (points, n_ctrl, 3) float64 displacements stay near 400 MB (the JAX
# package's chunking).
_CHUNK_ENTRIES = 1 << 24


@dataclasses.dataclass
class Tps:
    params: torch.Tensor    # (3, n_ctrl + 4) float64
    ctrl: torch.Tensor      # (n_ctrl, 3) float64 control points (mm)


def _u(r_sq: torch.Tensor) -> torch.Tensor:
    """U(r^2) = r^2 log(r^2), U(0) = 0 (imutil.c:2700-2705)."""
    pos = r_sq > 0
    safe = torch.where(pos, r_sq, torch.ones_like(r_sq))
    return torch.where(pos, r_sq * torch.log(safe), torch.zeros_like(r_sq))


def tps_apply(tps: Tps, pts) -> torch.Tensor:
    """Apply to (..., 3) points (apply_Tps_xyz semantics), on the TPS's
    device."""
    ctrl = tps.ctrl.to(F64)
    pts = torch.as_tensor(pts, device=ctrl.device).to(F64)
    d = pts[..., None, :] - ctrl                     # (..., n, 3)
    U = _u(torch.sum(d * d, dim=-1))                 # (..., n)
    n = ctrl.shape[0]
    w = tps.params[:, :n].to(F64)                    # (3, n)
    a = tps.params[:, n:].to(F64)                    # (3, 4)
    affine = a[:, 0] + torch.matmul(pts, a[:, 1:].T)
    return torch.matmul(U, w.T) + affine


def fit_tps(ctrl, targets, reg: float = 0.0) -> Tps:
    """Fit a TPS interpolating ctrl -> targets ((n, 3) each), on ctrl's
    device. ``reg`` > 0 relaxes exact interpolation toward smoothness
    (bending-energy regularization)."""
    ctrl = torch.as_tensor(ctrl).to(F64)
    targets = torch.as_tensor(targets, device=ctrl.device).to(F64)
    n = ctrl.shape[0]
    dev = ctrl.device
    d = ctrl[:, None, :] - ctrl[None, :, :]
    K = _u(torch.sum(d * d, dim=-1)) + reg * torch.eye(n, dtype=F64,
                                                       device=dev)
    P = torch.cat([torch.ones((n, 1), dtype=F64, device=dev), ctrl], 1)
    L = torch.cat([torch.cat([K, P], 1),
                   torch.cat([P.T, torch.zeros((4, 4), dtype=F64,
                                               device=dev)], 1)], 0)
    rhs = torch.cat([targets, torch.zeros((4, 3), dtype=F64, device=dev)], 0)
    sol = torch.linalg.solve(L, rhs)                 # (n + 4, 3)
    return Tps(params=sol.T.contiguous(), ctrl=ctrl)


def im_inv_transform_tps(tps: Tps, src: torch.Tensor, out_shape_zyx=None,
                         interp: str = "linear", src_units=(1.0, 1.0, 1.0),
                         ref_units=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Pull-warp ``src`` (nz, ny, nx) through a TPS (im_inv_transform with
    a Tps transform), on ``src``'s device.

    The TPS maps ref mm coordinates to src mm coordinates (the space
    ``register_pair_tps`` fits in): the output grid is the ref voxel grid
    scaled by ``ref_units``, and samples are taken at the result divided by
    ``src_units``. The grid goes ``(1 << 24) // n_ctrl`` points at a time.
    """
    sampler = _SAMPLERS[interp]
    if out_shape_zyx is None:
        out_shape_zyx = tuple(src.shape)
    nz, ny, nx = (int(n) for n in out_shape_zyx)
    dev = src.device
    tps = Tps(params=tps.params.to(dev), ctrl=tps.ctrl.to(dev))
    src = src.contiguous()
    ru = torch.as_tensor(ref_units, dtype=F64, device=dev)
    su = torch.as_tensor(src_units, dtype=F64, device=dev)
    out = torch.empty(nz * ny * nx, dtype=src.dtype, device=dev)
    chunk = max(1, _CHUNK_ENTRIES // max(int(tps.ctrl.shape[0]), 1))
    for i0 in range(0, out.numel(), chunk):
        i = torch.arange(i0, min(out.numel(), i0 + chunk), device=dev)
        pts = torch.stack([i % nx, i // nx % ny, i // (ny * nx)],
                          -1).to(F64) * ru
        p = tps_apply(tps, pts) / su
        out[i0:i0 + i.numel()] = sampler(src, p[:, 0], p[:, 1], p[:, 2])
    return out.reshape(nz, ny, nx)
