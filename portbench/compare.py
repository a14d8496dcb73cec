"""The comparison that decides ``correct``: the port's outputs against the
plain reference (``reference/``) on the same input volumes.

Pairs: per pair the affine A (3, 4) that maps ref voxel coordinates onto
src voxel coordinates, the matched coordinate pairs and the inlier
count. Two numbers over the sampled pairs:

- ``match_diff``: matched pairs in one set and not the other (rows
  compared to 1e-6 voxel), over the reference's matched pairs. A match
  exists only where both keypoints were detected (pyramid, extrema),
  oriented and described alike and the ratio test agreed;
- ``affine_gap_vox``: the largest distance, over the volume's 8 corners
  and the three axes, between where the two affines put a corner.

``tf32=True`` computes the reference with TF32 products: the
lower-precision control, which has to come out as not correct.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .reference import config as rcfg
from .reference import pyramid as rpyr
from .reference import register as rreg


@dataclasses.dataclass
class PairOut:
    A: np.ndarray          # (3, 4)
    match_src: np.ndarray  # (M, 3) voxel xyz
    match_ref: np.ndarray  # (M, 3)
    num_inliers: int
    ok: bool


def reference_params(cfg: dict):
    """The reference's SIFT3D, match and RANSAC parameters of a
    configuration file."""
    s = dict(cfg["sift3d"])
    if s.get("max_kp_per_octave") is not None:
        s["max_kp_per_octave"] = tuple(s["max_kp_per_octave"])
    return (rcfg.SIFT3DParams(**s), rcfg.MatchParams(**cfg["match"]),
            rcfg.RansacParams(**cfg["ransac"]))


@contextlib.contextmanager
def precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_pairs(src, ref, cfg: dict, device, tf32: bool = False,
                    block: int = 16) -> list:
    """The reference's PairOut of each (src[i], ref[i]) pair of host
    (n, nz, ny, nx) stacks, ``block`` pairs at a time."""
    params, match, ransac = reference_params(cfg)
    nz, ny, nx = cfg["shape_zyx"]
    units = tuple(cfg["units"])
    plan = rpyr.plan_pyramid((nx, ny, nz), units, params)
    out = []
    with precision(tf32), torch.no_grad():
        for a in range(0, len(src), block):
            _, d_src, ov_s = rreg.detect_describe(src[a:a + block], plan,
                                                  params, device)
            _, d_ref, ov_r = rreg.detect_describe(ref[a:a + block], plan,
                                                  params, device)
            res = rreg.register_pairs(d_src, d_ref, units, units, match,
                                      ransac, kp_overflow=ov_s | ov_r)
            out += pair_outs(res)
            del d_src, d_ref, res
    return out


def pair_outs(res) -> list:
    """PairOut of each pair of a batched registration result (the port's
    or the reference's: the same fields)."""
    A = res.A.cpu().numpy()
    n = res.num_matches.cpu().numpy()
    ms, mr = res.match_src.cpu().numpy(), res.match_ref.cpu().numpy()
    ni, ok = res.num_inliers.cpu().numpy(), res.ok.cpu().numpy()
    return [PairOut(A[b], ms[b, :n[b]], mr[b, :n[b]], int(ni[b]), bool(ok[b]))
            for b in range(A.shape[0])]


def _corners(shape_zyx) -> np.ndarray:
    nz, ny, nx = shape_zyx
    return np.array([[x, y, z, 1.0] for x in (0, nx - 1) for y in (0, ny - 1)
                     for z in (0, nz - 1)])


def affine_gap(A1, A2, corners) -> float:
    """The largest coordinate gap between two affines over the corners;
    0 where both are non-finite alike (no model on either side)."""
    both_bad = ~np.isfinite(A1) & ~np.isfinite(A2)
    d = np.where(both_bad, 0.0, np.asarray(A1, float) - np.asarray(A2, float))
    if not np.isfinite(d).all():
        return float("inf")
    return float(np.abs(d @ corners.T).max())


def _rows(p: PairOut) -> set:
    return set(map(tuple, np.round(np.hstack([p.match_src, p.match_ref]),
                                   6).tolist()))


def pair_numbers(prog: list, ref: list, shape_zyx) -> dict:
    """``match_diff`` and ``affine_gap_vox`` of the program's PairOuts
    against the reference's, pair by pair."""
    if len(prog) != len(ref) or not ref:
        raise ValueError(f"{len(prog)} program pairs against {len(ref)}")
    corners = _corners(shape_zyx)
    diff = total = 0
    gap = 0.0
    for p, r in zip(prog, ref):
        P, R = _rows(p), _rows(r)
        diff += len(P ^ R)
        total += len(R)
        gap = max(gap, affine_gap(p.A, r.A, corners))
    return dict(match_diff=diff / max(total, 1), affine_gap_vox=gap)
