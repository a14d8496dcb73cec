"""Dense per-voxel descriptors, and the raw-image input they share with the
raw descriptor and orientation paths.

Reproduces SIFT3D_extract_dense_descriptors (reference
sift3d/sift.c:2354-2424), as ``sift3d_tpu/features/dense.py`` does:

- ``smooth_scale_raw_input``: the raw input blurred from sigma_n to sigma0
  and scaled to [-1, 1] (sift.c:1978-2006); the raw-image paths
  (``features/orientation.assign_orientations_raw``,
  ``features/descriptor.extract_raw_descriptors``) start from it too;
- the default mode (extract_dense_descriptors_no_rotate,
  sift.c:2429-2496): at every interior voxel the unit-corrected gradient's
  icosahedral face, its 3 barycentric weights written into the face's 3
  vertex channels of a 12-channel image (unweighted by magnitude), a blur
  of that image with sigma = sigma0 * desc_sig_fctr / NHIST_PER_DIM at
  unit tap spacing (the reference's quirk: the 12-channel image takes the
  input's dims but not its units), then per voxel normalize, truncate,
  renormalize and scale by the raw intensity (postproc_Hist,
  sift.c:2267-2292);
- above ``DENSE_CHANNEL_SEQ_VOX`` voxels the splat, blur and
  postprocessing go one channel at a time (``_dense_channels_seq``), so
  that the peak is the (12, V) result and one channel of temporaries;
- the rotation-invariant mode (``SIFT3DParams.dense_rotate``,
  extract_dense_descriptors_rotate, sift.c:2521-2588): every voxel is
  oriented at sd = sigma0 (rejected voxels take R = I) and accumulates one
  12-bin histogram of its window's gradients rotated by R^T.

The splat, blur and postprocessing are dense tensor work (the banded
convolution of ``ops/conv.py``, dense or framed), as the JAX package computes them
outside any Pallas kernel. The rotate mode's orientations are one
``orient_terms_levels`` call per ``DENSE_ORIENT_ROWS`` voxels, each voxel a
row of one level: kernel 3 on the card. Its per-voxel window histograms,
which JAX maps with ``jax.lax.map``, are plain torch over chunks of
``DENSE_HIST_VOXELS`` window voxels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (DESC_NUMEL, DESC_RAD_FCTR, DESC_SIG_FCTR, HIST_NUMEL,
                      NHIST_PER_DIM, TRUNC_THRESH, SIFT3DParams)
from ..dtypes import F64
from ..ops import conv
from ..ops.gauss import gauss_taps, incremental_sigma
from ..ops.geometry import face_tables, icos_hist_bin, vertex_weights
from ..pyramid import im_scale
from .windows import (gather_windows, window_extent, window_gradients,
                      window_starts)

_DBL_EPSILON = 2.220446049250313e-16
# Above this many voxels the splat-and-blur path goes one channel at a
# time (the JAX package's switch and value): the all-at-once path holds
# (V, 20) face scores and (V, 12) weights, 10.7 GB + 6.4 GB at 512^3.
DENSE_CHANNEL_SEQ_VOX = 1 << 25
# Voxels per chunk of the icosahedral binning (bounds its (C, 20) scores).
_BIN_VOXELS = 1 << 23
# The rotate mode: rows per orientation call (bounds its (C, 6) float64
# sums; 512^3 voxels at once would take 6.4 GB) and window voxels per
# chunk of the histograms (about 0.3 KB of temporaries a window voxel).
DENSE_ORIENT_ROWS = 1 << 22
DENSE_HIST_VOXELS = 1 << 22


def smooth_scale_raw_input(vol: torch.Tensor, units,
                           params: SIFT3DParams) -> torch.Tensor:
    """sigma_n -> sigma0 blur + scale to [-1, 1] (sift.c:1978-2006) of a
    (nz, ny, nx) volume, on its device."""
    taps = gauss_taps(incremental_sigma(params.sigma_n, params.sigma0))
    return im_scale(conv.conv_sep(vol.to(torch.float32), taps, 1.0, units))


def _interior_grad_bin(smooth: torch.Tensor, units):
    """Per-voxel unit-corrected gradient at interior voxels [1, n-2] only
    (sift.c:2442-2447), icosahedrally binned (``_BIN_VOXELS`` at a time).
    Returns (face (z, y, x) int64, bary (z, y, x, 3), ok (z, y, x)) with
    boundary voxels masked out of ``ok``."""
    gi = window_gradients(smooth, units)        # core = interior voxels
    grad = torch.zeros(smooth.shape + (3,), dtype=torch.float32,
                       device=smooth.device)
    for a, g in enumerate(gi):
        grad[1:-1, 1:-1, 1:-1, a] = g
    del gi
    flat = grad.reshape(-1, 3)
    parts = [icos_hist_bin(flat[i:i + _BIN_VOXELS])
             for i in range(0, flat.shape[0], _BIN_VOXELS)]
    face, bary, ok = (torch.cat(t).reshape(smooth.shape + t[0].shape[1:])
                      for t in zip(*parts))
    interior = torch.zeros(smooth.shape, dtype=torch.bool,
                           device=smooth.device)
    interior[1:-1, 1:-1, 1:-1] = True
    return face, bary, ok & interior


def _bary_splat(smooth: torch.Tensor, units) -> torch.Tensor:
    """(12, nz, ny, nx) barycentric vertex weights per voxel."""
    face, bary, ok = _interior_grad_bin(smooth, units)
    w = vertex_weights(face, bary)                           # (z, y, x, 12)
    w = w * ok[..., None].to(torch.float32)
    return torch.movedim(w, -1, 0)                           # (12, z, y, x)


def _trunc() -> float:
    """The truncation threshold, trunc_thresh * 64, rounded in fp32."""
    return float(np.float32(TRUNC_THRESH) *
                 np.float32(DESC_NUMEL / HIST_NUMEL))


def postproc_hist(hist: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Per-voxel normalize -> truncate -> renormalize -> scale
    (postproc_Hist, sift.c:2267-2292). hist: (..., 12); norm: (...). The
    norms are taken in float64."""
    def normalize(v):
        n = torch.sqrt(torch.sum(v.to(F64) ** 2, -1, keepdim=True)) + \
            _DBL_EPSILON
        return v * (1.0 / n).to(torch.float32)
    v = normalize(hist)
    v = torch.clamp(v, max=_trunc())
    v = normalize(v)
    return v * norm[..., None].to(torch.float32)


def _splat_compact(smooth: torch.Tensor, units):
    """Per-voxel (3,) vertex ids and (3,) barycentric weights: the compact
    form of the 12-channel splat, (3, z, y, x) uint8 and (3, z, y, x)
    float32."""
    face, bary, ok = _interior_grad_bin(smooth, units)
    idx = torch.as_tensor(face_tables()["idx"], device=smooth.device)
    vt = torch.movedim(idx.to(torch.uint8)[face], -1, 0)
    w = bary * ok[..., None].to(torch.float32)
    del face, bary, ok
    return vt, torch.movedim(w, -1, 0)


def _dense_channels_seq(vol: torch.Tensor, smooth: torch.Tensor, units,
                        taps) -> torch.Tensor:
    """Channel-sequential splat + blur + postprocess: the peak is the
    (12, V) result and one channel of temporaries, not the 20-channel
    binning intermediates. The final scaling overwrites the result a
    channel at a time."""
    vt, w = _splat_compact(smooth, units)
    out = torch.empty((HIST_NUMEL,) + tuple(vol.shape), dtype=torch.float32,
                      device=vol.device)
    for c in range(HIST_NUMEL):
        w_c = sum(w[j] * (vt[j] == c).to(torch.float32) for j in range(3))
        out[c] = conv.conv_sep(w_c, taps, 1.0, (1.0, 1.0, 1.0))
        del w_c
    del vt, w

    # postproc_Hist (sift.c:2267-2292) with channel-at-a-time reductions.
    trunc = _trunc()

    def norm(chan):
        acc = torch.zeros(vol.shape, dtype=F64, device=vol.device)
        for c in range(HIST_NUMEL):
            acc += chan(c).to(F64) ** 2
        return torch.sqrt(acc)
    inv1 = (1.0 / (norm(lambda c: out[c]) + _DBL_EPSILON)).to(torch.float32)
    inv2 = (1.0 / (norm(lambda c: torch.clamp(out[c] * inv1, max=trunc)) +
                   _DBL_EPSILON)).to(torch.float32) * vol
    for c in range(HIST_NUMEL):
        out[c] = torch.clamp(out[c] * inv1, max=trunc) * inv2
    return out


def dense_orient_call(smooth: torch.Tensor, units, params: SIFT3DParams,
                      v0: int, v1: int):
    """``orient_terms_levels``' arguments for the voxels [v0, v1) of
    ``smooth`` (flat z, y, x order), each a row of one level at sd =
    sigma0: (rows (v1 - v0, 4), [level tuple])."""
    from .orientation import level_geometry

    ny, nx = smooth.shape[1:]
    sigma, rad, radii, cores = level_geometry(params.sigma0, units,
                                              smooth.shape)
    i = torch.arange(v0, v1, device=smooth.device)
    rows = torch.stack([torch.zeros_like(i), i // (ny * nx), i // nx % ny,
                        i % nx], 1)
    n = v1 - v0
    return rows, [(smooth[None], n, n, radii, cores, units, sigma, rad)]


def dense_orientations(smooth: torch.Tensor, units, params: SIFT3DParams,
                       terms=None):
    """The rotate mode's per-voxel orientations: every voxel of ``smooth``
    is a row of one level at sd = sigma0, ``DENSE_ORIENT_ROWS`` rows a call
    of ``terms`` (``orient_terms_levels``, or its plain version).

    Returns (R (V, 3, 3) float32 with R = I where rejected, A6 (V, 6)
    float64 and vd (V, 3) float32, the window sums the tests read)."""
    from ..ops.cuda_orient import orient_terms_levels
    from .orientation import orientations_from_tensor

    terms = orient_terms_levels if terms is None else terms
    dev = smooth.device
    V = smooth.numel()
    R = torch.empty((V, 3, 3), dtype=torch.float32, device=dev)
    A6 = torch.empty((V, 6), dtype=F64, device=dev)
    vd = torch.empty((V, 3), dtype=torch.float32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    for v0 in range(0, V, DENSE_ORIENT_ROWS):
        v1 = min(V, v0 + DENSE_ORIENT_ROWS)
        A6[v0:v1], vd[v0:v1] = terms(*dense_orient_call(smooth, units,
                                                        params, v0, v1))
        r, valid = orientations_from_tensor(A6[v0:v1], vd[v0:v1],
                                            params.corner_thresh)
        R[v0:v1] = torch.where(valid[:, None, None], r, eye)
    return R, A6, vd


def _dense_hist_chunk(smooth, zyx, R, radii, cores, units, rad2, sig2):
    """(C, 12) rotation-invariant histograms of C voxels
    (extract_dense_descrip_rotate, sift.c:2295-2343): sphere window of
    radius ``rad`` (mm) around each voxel, unit-corrected gradients
    rotated by R^T for binning, |g| x Gaussian weight into the face's 3
    vertex bins."""
    C = zyx.shape[0]
    dev = smooth.device
    starts = window_starts(smooth.shape, zyx, radii, cores)
    win = gather_windows(smooth[None], torch.zeros(C, dtype=torch.long,
                                                   device=dev), starts, cores)
    gx, gy, gz = window_gradients(win, units)
    u = [float(np.float32(x)) for x in units[::-1]]          # z, y, x
    d = [((starts[:, a, None] + torch.arange(cores[a], device=dev)) -
          zyx[:, a, None]).to(torch.float32) * u[a] for a in range(3)]
    vz = d[0][:, :, None, None]
    vy = d[1][:, None, :, None]
    vx = d[2][:, None, None, :]
    sq = vx * vx + vy * vy + vz * vz
    mask = sq <= rad2
    w = torch.exp(-0.5 * sq / sig2)
    Rc = [[R[:, j, i, None, None, None] for j in range(3)] for i in range(3)]
    grad_rot = torch.stack([Rc[i][0] * gx + Rc[i][1] * gy + Rc[i][2] * gz
                            for i in range(3)], -1).reshape(C, -1, 3)
    face, bary, ok = icos_hist_bin(grad_rot)
    mag = torch.sqrt(gx * gx + gy * gy + gz * gz).reshape(C, -1)
    wgt = (mask.reshape(C, -1) & ok).to(torch.float32) * \
        w.reshape(C, -1) * mag
    G = vertex_weights(face, bary)                           # (C, V, 12)
    return torch.sum(G * wgt[..., None], 1)


def dense_rotate_histograms(smooth: torch.Tensor, R: torch.Tensor, units,
                            params: SIFT3DParams) -> torch.Tensor:
    """(V, 12) window histograms of every voxel with its orientation R
    (V, 3, 3), ``DENSE_HIST_VOXELS`` window voxels at a time."""
    from .orientation import window_radii

    dev = smooth.device
    nz, ny, nx = smooth.shape
    V = nz * ny * nx
    desc_sigma = params.sigma0 * DESC_SIG_FCTR / NHIST_PER_DIM
    rad = DESC_RAD_FCTR * desc_sigma
    Rx, Ry, Rz = window_radii(rad, units)
    radii = (Rz, Ry, Rx)
    cores = (window_extent(Rz, nz, True), window_extent(Ry, ny, True),
             window_extent(Rx, nx, True))
    rad2 = float(np.float32(rad) * np.float32(rad))
    sig2 = float(np.float32(desc_sigma) * np.float32(desc_sigma))
    chunk = max(1, DENSE_HIST_VOXELS // (cores[0] * cores[1] * cores[2]))
    hist = torch.empty((V, HIST_NUMEL), dtype=torch.float32, device=dev)
    for v0 in range(0, V, chunk):
        v1 = min(V, v0 + chunk)
        i = torch.arange(v0, v1, device=dev)
        zyx = torch.stack([i // (ny * nx), i // nx % ny, i % nx], 1)
        hist[v0:v1] = _dense_hist_chunk(smooth, zyx, R[v0:v1], radii, cores,
                                        units, rad2, sig2)
    return hist


def _extract_dense_rotate(vol, smooth, units, params) -> torch.Tensor:
    """Rotation-invariant dense path (extract_dense_descriptors_rotate,
    sift.c:2521-2588): per voxel an orientation with sigma = sigma0 *
    ori_sig_fctr (identity when rejected), then one windowed
    rotated-gradient histogram with sigma = sigma0 * desc_sig_fctr /
    NHIST_PER_DIM."""
    R, _, _ = dense_orientations(smooth, units, params)
    hist = dense_rotate_histograms(smooth, R, units, params)
    del R
    out = postproc_hist(hist, vol.reshape(-1))
    return out.T.reshape((HIST_NUMEL,) + tuple(vol.shape))


def extract_dense_descriptors(vol: torch.Tensor, units=(1.0, 1.0, 1.0),
                              params: SIFT3DParams = SIFT3DParams()
                              ) -> torch.Tensor:
    """Dense descriptor image (12, nz, ny, nx) float32 of a (nz, ny, nx)
    volume, on its device.

    Channel b holds icosahedral-vertex bin b, matching the reference's
    12-channel output (sift.c:2383-2386). ``params.dense_rotate`` selects
    the rotation-invariant path instead of splat-and-blur.
    """
    vol = vol.to(torch.float32)
    smooth = smooth_scale_raw_input(vol, units, params)
    if params.dense_rotate:
        return _extract_dense_rotate(vol, smooth, units, params)
    taps = gauss_taps(params.sigma0 * DESC_SIG_FCTR / NHIST_PER_DIM)
    # Reference quirk, reproduced: the 12-channel image takes only its
    # dims from the input (sift.c:2383-2386), never its units, so this
    # blur runs at unit spacing even for anisotropic volumes, while the
    # gradients above are unit-corrected.
    if vol.numel() >= DENSE_CHANNEL_SEQ_VOX:
        return _dense_channels_seq(vol, smooth, units, taps)
    blurred = conv.conv_sep(_bary_splat(smooth, units), taps, 1.0,
                            (1.0, 1.0, 1.0))
    out = postproc_hist(torch.movedim(blurred, 0, -1), vol)
    return torch.movedim(out, -1, 0).contiguous()
