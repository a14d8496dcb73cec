"""Synthetic input volumes, made on the device from the run's seed.

The blob model of the SIFT3D benches: randomly oriented anisotropic
Gaussian blobs (axis ratios up to ``aniso``, sigma ``sig_lo``-``sig_hi``
voxels, amplitudes ``amp_lo``-1, centres at least 4 voxels inside), each
evaluated within 5 of its largest sigma of its centre along each axis.
Isotropic blobs would fail the detector's corner test and give a handful of
keypoints a volume; these give some 60-150 at 64^3. Every parameter is
drawn by a ``torch.Generator`` on the device in a few large calls, so the
same seed gives the same volumes on the same kind of device.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)


def blob_volumes(n: int, shape_zyx, nblob: int, gen: torch.Generator,
                 device, aniso: float = 2.0, sig_lo: float = 1.5,
                 sig_hi: float = 4.0, amp_lo: float = 0.3,
                 chunk_voxels: int = 1 << 26,
                 padded_voxels: int = 1 << 30) -> torch.Tensor:
    """(n, nz, ny, nx) float32 blob volumes on ``device``.

    Each blob is evaluated in a box of the largest half-width any blob
    can have around its centre, on a copy of the volumes padded by that
    width, blob by blob over all volumes at once; within one blob the
    boxes of different volumes never overlap, so each voxel takes one
    addition a blob and the sum does not depend on the order of the
    device's adds."""
    dims = torch.tensor(shape_zyx, dtype=torch.float32, device=device)
    u = torch.rand((n, nblob, 8), generator=gen, device=device)
    g = torch.randn((n, nblob, 3, 3), generator=gen, device=device)
    centre = 4.0 + u[..., :3] * (dims - 8.0)                  # (n, b, 3) zyx
    sig0 = sig_lo + u[..., 3] * (sig_hi - sig_lo)
    sig = torch.stack([sig0, sig0 * (1.0 + u[..., 4] * (aniso - 1.0)),
                       sig0 * (1.0 + u[..., 5] * (aniso - 1.0))], -1)
    amp = amp_lo + u[..., 6] * (1.0 - amp_lo)
    Q = torch.linalg.qr(g.cpu().double())[0].to(device=device,
                                                 dtype=torch.float32)
    Sinv = Q @ torch.diag_embed(1.0 / sig ** 2) @ Q.transpose(-1, -2)
    r = 5.0 * sig.amax(-1)                                     # (n, b)
    half = int(math.ceil(5.0 * sig_hi * aniso))       # the widest box's
    off = torch.arange(-half, half + 1, device=device)
    box = off.numel() ** 3
    pad = half + 1
    pz, py, px = (m + 2 * pad for m in shape_zyx)
    nz, ny, nx = shape_zyx
    out = torch.empty((n, nz, ny, nx), dtype=torch.float32, device=device)
    nv = max(1, min(n, chunk_voxels // box,
                    padded_voxels // (pz * py * px)))     # volumes a chunk
    for a in range(0, n, nv):
        b = min(n, a + nv)
        acc = torch.zeros((b - a) * pz * py * px, dtype=torch.float32,
                          device=device)
        vol = torch.arange(b - a, device=device)
        for j in range(nblob):
            c = centre[a:b, j]                                 # (v, 3)
            at = torch.floor(c).long()[:, :, None] + off       # (v, 3, L)
            d = at.float() - c[:, :, None]
            dz = d[:, 0, :, None, None]
            dy = d[:, 1, None, :, None]
            dx = d[:, 2, None, None, :]
            S = Sinv[a:b, j, :, :, None, None, None]
            q = (S[:, 0, 0] * dz * dz + S[:, 1, 1] * dy * dy +
                 S[:, 2, 2] * dx * dx +
                 2.0 * (S[:, 0, 1] * dz * dy + S[:, 0, 2] * dz * dx +
                        S[:, 1, 2] * dy * dx))
            rr = r[a:b, j, None, None, None]
            inside = (dz.abs() <= rr) & (dy.abs() <= rr) & (dx.abs() <= rr)
            w = torch.where(inside, torch.exp(-0.5 * q), 0.0) * \
                amp[a:b, j, None, None, None]
            p = at + pad
            idx = (((vol[:, None, None, None] * pz + p[:, 0, :, None, None])
                    * py + p[:, 1, None, :, None]) * px +
                   p[:, 2, None, None, :])
            acc.index_add_(0, idx.reshape(-1), w.reshape(-1))
        out[a:b] = acc.view(b - a, pz, py, px)[:, pad:pad + nz,
                                               pad:pad + ny, pad:pad + nx]
        del acc
    return out


def pairs(n: int, shape_zyx, nblob: int, shift_x: int, gen, device):
    """(src, ref) stacks of n pairs: ref is src rolled ``shift_x`` voxels
    along x, so the affine that maps ref onto src is [I | (-shift, 0, 0)]."""
    src = blob_volumes(n, shape_zyx, nblob, gen, device)
    return src, torch.roll(src, shift_x, dims=-1)
