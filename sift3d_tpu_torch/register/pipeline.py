"""Pairwise registration pipeline.

Reproduces register_SIFT3D (reference reg/reg.c:239-317), as
``sift3d_tpu/register/pipeline.py`` does: match descriptors, convert
matched coordinates from voxels to mm (im2mm, reg.c:43-68), fit an affine
with RANSAC in mm space, and convert the transform back to voxel space
(mm2im, reg.c:79-117). The affine A (3x4) maps *ref* voxel coordinates to
*src* voxel coordinates, like the reference's output.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..config import MatchParams, RansacParams
from ..dtypes import F64
from ..features.descriptor import Descriptors
from ..features.match import matches_to_coords, nn_match
from ..ops.cuda_match import nn_match_streamed
from .ransac import find_tform_ransac


@dataclasses.dataclass
class RegistrationResult:
    A: torch.Tensor            # (3, 4) f64 affine in voxel space, ref -> src
    matches: torch.Tensor      # (N_src,) i32 match indices into ref (-1 = none)
    match_src: torch.Tensor    # (N_src, 3) f64 padded matched src voxel coords
    match_ref: torch.Tensor    # (N_src, 3) f64 padded matched ref voxel coords
    num_matches: int
    num_inliers: int
    ok: bool
    # True when keypoints were truncated at a level capacity upstream of
    # the descriptors (the reference's keypoint store is unbounded,
    # immacros.h:199-222, so loss must be surfaced).
    kp_overflow: bool


def im2mm(pts: torch.Tensor, units) -> torch.Tensor:
    """Voxel -> mm: scale column j by units[j] (reg.c:43-68)."""
    u = torch.as_tensor(units, dtype=F64, device=pts.device)
    return pts.to(F64) * u[None, :]


def mm2im(A_mm: torch.Tensor, src_units, ref_units) -> torch.Tensor:
    """Convert an affine from mm to voxel space (reg.c:79-117):
    A_im[i, j] = A_mm[i, j] * (ref_units[j] if j < 3 else 1) / src_units[i]."""
    ru = torch.as_tensor(tuple(ref_units) + (1.0,), dtype=F64,
                         device=A_mm.device)
    su = torch.as_tensor(src_units, dtype=F64, device=A_mm.device)
    return A_mm * ru[None, :] / su[:, None]


def use_streamed(n1: int, n2: int, match_params: MatchParams,
                 device: torch.device) -> bool:
    """The streamed kernel runs for impl="streamed", or for impl="auto"
    on the card once the SSD matrix reaches streamed_threshold entries."""
    return match_params.impl == "streamed" or (
        match_params.impl == "auto" and device.type == "cuda" and
        n1 * n2 >= match_params.streamed_threshold)


def register_pair(desc_src: Descriptors, desc_ref: Descriptors,
                  src_units, ref_units,
                  match_params: MatchParams = MatchParams(),
                  ransac_params: RansacParams = RansacParams(),
                  ransac_idx: torch.Tensor | None = None,
                  kp_overflow: bool = False) -> RegistrationResult:
    """Register a (src, ref) descriptor pair.

    ``desc_src`` plays d1 (queries) and ``desc_ref`` d2 in matching
    (reg.c:271), and the fit maps ref coordinates onto src coordinates.
    ``ransac_idx`` optionally injects the RANSAC hypothesis draws.
    """
    n1, n2 = desc_src.capacity, desc_ref.capacity
    match = nn_match_streamed if use_streamed(
        n1, n2, match_params, desc_src.vec.device) else nn_match
    with record_function("sift3d.match"):
        matches = match(desc_src.vec, desc_ref.vec, match_params.nn_thresh,
                        valid1=desc_src.valid_mask(),
                        valid2=desc_ref.valid_mask())
        src_xyz, ref_xyz, n_match = matches_to_coords(
            desc_src.xyz, desc_ref.xyz, matches)
    with record_function("sift3d.ransac"):
        res = find_tform_ransac(im2mm(src_xyz, src_units),
                                im2mm(ref_xyz, ref_units), n_match,
                                ransac_params, idx=ransac_idx)
        A = mm2im(res.A, src_units, ref_units)
    return RegistrationResult(
        A=A, matches=matches,
        match_src=src_xyz, match_ref=ref_xyz, num_matches=n_match,
        num_inliers=res.num_inliers, ok=res.ok, kp_overflow=kp_overflow)
