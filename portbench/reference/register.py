"""Registration of descriptor pairs: matching, RANSAC, the affine.

A frozen copy of the port's ``register/pipeline.py`` (register_SIFT3D,
reg/reg.c:239-317) with the dense matcher only, and of the batch
padding of ``parallel/pipeline.py``, so that ``detect_describe`` gives
(B, K) descriptor sets of a batch of volumes as the port's batched path
does.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import F64, MatchParams, RansacParams
from .descrip import Descriptors, extract_descriptors
from .detect import detect
from .keypoints import FIELDS, Keypoints
from .match import matches_to_coords, nn_match
from .ransac import find_tform_ransac


def _by_volume(vol: torch.Tensor, n_vols: int):
    """Each row's place among its volume's rows (in row order), and the
    largest number of rows of a volume."""
    counts = torch.bincount(vol, minlength=n_vols)
    order = torch.argsort(vol, stable=True)
    pos = torch.empty_like(vol)
    pos[order] = torch.arange(vol.shape[0], device=vol.device) - \
        (torch.cumsum(counts, 0) - counts)[vol[order]]
    return pos, counts, (int(counts.max()) if vol.numel() else 0)


def _pad(t: torch.Tensor, vol, pos, n_vols: int, K: int) -> torch.Tensor:
    """Flat rows as a zero-padded (n_vols, K, ...) batch."""
    out = t.new_zeros((n_vols, K) + t.shape[1:])
    out[vol, pos] = t
    return out


def _per_volume(kp: Keypoints, desc: Descriptors, vol: torch.Tensor,
                n_vols: int):
    """The flat rows of a batch as (B, K) sets with (B,) counts, K the
    largest count; each volume keeps its rows in their order."""
    pos, counts, K = _by_volume(vol, n_vols)

    def pad(t):
        return _pad(t, vol, pos, n_vols, K)
    kp_b = Keypoints(**{f: pad(getattr(kp, f)) for f in FIELDS},
                     count=counts)
    desc_b = Descriptors(xyz=pad(desc.xyz), sd=pad(desc.sd),
                         vec=pad(desc.vec), count=counts)
    return kp_b, desc_b


def detect_describe(vols, plan, params, device):
    """Keypoints and descriptors of a (B, nz, ny, nx) batch: (B, K) sets
    with (B,) counts, and the (B,) overflow flags."""
    gpyr, kp, vol, overflow = detect(vols, plan, params, device)
    desc = extract_descriptors(gpyr, kp, plan, vol=vol)
    kp_b, desc_b = _per_volume(kp, desc, vol, overflow.shape[0])
    return kp_b, desc_b, overflow


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


def register_pairs(desc_src: Descriptors, desc_ref: Descriptors,
                   src_units, ref_units,
                   match_params: MatchParams = MatchParams(),
                   ransac_params: RansacParams = RansacParams(),
                   kp_overflow: torch.Tensor | None = None,
                   ssd_dtype=torch.float32) -> RegistrationResult:
    """Register B (src, ref) descriptor pairs at once: (B, K, 768) sets
    with (B,) counts. ``desc_src`` plays the queries, and the affine maps
    ref voxel coordinates onto src voxel coordinates."""
    v1, v2 = desc_src.valid_mask(), desc_ref.valid_mask()
    matches = nn_match(desc_src.vec, desc_ref.vec, match_params.nn_thresh,
                       valid1=v1, valid2=v2, dtype=ssd_dtype)
    src_xyz, ref_xyz, n_match = matches_to_coords(
        desc_src.xyz, desc_ref.xyz, matches)
    res = find_tform_ransac(im2mm(src_xyz, src_units),
                            im2mm(ref_xyz, ref_units), n_match,
                            ransac_params)
    A = mm2im(res.A, src_units, ref_units)
    if kp_overflow is None:
        kp_overflow = torch.zeros_like(res.ok)
    return RegistrationResult(
        A=A, matches=matches, match_src=src_xyz, match_ref=ref_xyz,
        num_matches=n_match, num_inliers=res.num_inliers, ok=res.ok,
        inlier_mask=res.inlier_mask, kp_overflow=kp_overflow)
