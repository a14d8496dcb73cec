"""Pairwise registration pipeline.

Reproduces register_SIFT3D (reference reg/reg.c:239-317), as
``sift3d_tpu/register/pipeline.py`` does: match descriptors, convert
matched coordinates from voxels to mm (im2mm, reg.c:43-68), fit an affine
with RANSAC in mm space, and convert the transform back to voxel space
(mm2im, reg.c:79-117). The affine A (3x4) maps *ref* voxel coordinates to
*src* voxel coordinates, like the reference's output. ``register_pairs``
registers a batch of pairs at once; ``register_pair`` is a batch of one.
``register_pair_tps`` fits a thin-plate spline on the inliers of that
affine (``register/tps.py``).
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
from .tps import fit_tps


@dataclasses.dataclass
class RegistrationResult:
    """For one pair; ``register_pairs`` gives every field a leading B axis
    and (B,) tensors for the counts and flags."""
    A: torch.Tensor            # (3, 4) f64 affine in voxel space, ref -> src
    matches: torch.Tensor      # (N_src,) i32 match indices into ref (-1 = none)
    match_src: torch.Tensor    # (N_src, 3) f64 padded matched src voxel coords
    match_ref: torch.Tensor    # (N_src, 3) f64 padded matched ref voxel coords
    num_matches: int
    num_inliers: int
    ok: bool
    # (N_src,) bool: the rows of match_src / match_ref that the mm-space
    # affine's consensus set holds.
    inlier_mask: torch.Tensor
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


def register_pairs(desc_src: Descriptors, desc_ref: Descriptors,
                   src_units, ref_units,
                   match_params: MatchParams = MatchParams(),
                   ransac_params: RansacParams = RansacParams(),
                   ransac_idx: torch.Tensor | None = None,
                   kp_overflow: torch.Tensor | None = None,
                   ssd_dtype=torch.float32) -> RegistrationResult:
    """Register B (src, ref) descriptor pairs at once (``jax.vmap`` of
    ``register_pair`` in the JAX package's ``batch_register_pairs``).

    The sets carry a leading batch axis: (B, K, 768) vectors and (B,)
    counts. ``desc_src`` plays d1 (queries) and ``desc_ref`` d2 in matching
    (reg.c:271), and the fit maps ref coordinates onto src coordinates.
    ``ransac_idx`` (B, H, 4) optionally injects the RANSAC hypothesis
    draws; ``kp_overflow`` (B,) is passed through. ``ssd_dtype`` is the
    dense matcher's SSD precision (``features.match.nn_match``); the
    streamed kernel matches in fp32 whatever it is, as in the JAX
    package. Returns a
    RegistrationResult with a leading batch axis; nothing waits on the
    host.
    """
    n1, n2 = desc_src.capacity, desc_ref.capacity
    v1, v2 = desc_src.valid_mask(), desc_ref.valid_mask()
    thresh = match_params.nn_thresh
    with record_function("sift3d.match"):
        if use_streamed(n1, n2, match_params, desc_src.vec.device):
            matches = torch.stack([
                nn_match_streamed(a, b, thresh, valid1=m1, valid2=m2)
                for a, b, m1, m2 in zip(desc_src.vec, desc_ref.vec, v1, v2)])
        else:
            matches = nn_match(desc_src.vec, desc_ref.vec, thresh,
                               valid1=v1, valid2=v2, dtype=ssd_dtype)
        src_xyz, ref_xyz, n_match = matches_to_coords(
            desc_src.xyz, desc_ref.xyz, matches)
    with record_function("sift3d.ransac"):
        res = find_tform_ransac(im2mm(src_xyz, src_units),
                                im2mm(ref_xyz, ref_units), n_match,
                                ransac_params, idx=ransac_idx)
        A = mm2im(res.A, src_units, ref_units)
    if kp_overflow is None:
        kp_overflow = torch.zeros_like(res.ok)
    return RegistrationResult(
        A=A, matches=matches, match_src=src_xyz, match_ref=ref_xyz,
        num_matches=n_match, num_inliers=res.num_inliers, ok=res.ok,
        inlier_mask=res.inlier_mask, kp_overflow=kp_overflow)


def _batch_of_one(d: Descriptors) -> Descriptors:
    return Descriptors(xyz=d.xyz[None], sd=d.sd[None], vec=d.vec[None],
                       count=torch.tensor([d.count], device=d.vec.device))


def register_pair(desc_src: Descriptors, desc_ref: Descriptors,
                  src_units, ref_units,
                  match_params: MatchParams = MatchParams(),
                  ransac_params: RansacParams = RansacParams(),
                  ransac_idx: torch.Tensor | None = None,
                  kp_overflow: bool = False,
                  ssd_dtype=torch.float32) -> RegistrationResult:
    """Register one (src, ref) descriptor pair: ``register_pairs`` on a
    batch of one. ``ransac_idx`` (H, 4) optionally injects the RANSAC
    hypothesis draws; ``ssd_dtype`` as in ``register_pairs``.
    """
    res = register_pairs(_batch_of_one(desc_src), _batch_of_one(desc_ref),
                         src_units, ref_units, match_params, ransac_params,
                         None if ransac_idx is None else ransac_idx[None],
                         ssd_dtype=ssd_dtype)
    n_match, n_in, ok = torch.stack(
        [res.num_matches[0], res.num_inliers[0], res.ok[0].long()]).tolist()
    return RegistrationResult(
        A=res.A[0], matches=res.matches[0], match_src=res.match_src[0],
        match_ref=res.match_ref[0], num_matches=n_match, num_inliers=n_in,
        ok=bool(ok), inlier_mask=res.inlier_mask[0], kp_overflow=kp_overflow)


def register_pair_tps(desc_src: Descriptors, desc_ref: Descriptors,
                      src_units, ref_units,
                      match_params: MatchParams = MatchParams(),
                      ransac_params: RansacParams = RansacParams(),
                      reg: float = 1e-6,
                      ransac_idx: torch.Tensor | None = None,
                      kp_overflow: bool = False):
    """Nonrigid registration: the affine RANSAC of ``register_pair`` for
    outlier rejection, then a thin-plate spline fit on its inliers (a
    capability the reference declares but never implemented,
    imutil.c:4504-4508).

    The spline maps ref mm coordinates to src mm coordinates (warp with
    ``register.tps.im_inv_transform_tps``). Its control points are the
    inliers of the mm-space affine that the returned result holds, taken
    from that same run (``ransac_idx`` (H, 4) optionally injects its
    hypothesis draws). Returns (RegistrationResult, Tps or None): None
    when the affine stage found no model or fewer than 5 inliers.
    """
    res = register_pair(desc_src, desc_ref, src_units, ref_units,
                        match_params, ransac_params, ransac_idx, kp_overflow)
    if not res.ok:      # also fewer than RANSAC_MIN_INLIERS inliers
        return res, None
    n = res.num_matches
    inl = res.inlier_mask[:n]
    src_mm = im2mm(res.match_src[:n][inl], src_units)
    ref_mm = im2mm(res.match_ref[:n][inl], ref_units)
    with record_function("sift3d.tps"):
        return res, fit_tps(ref_mm, src_mm, reg=reg)
