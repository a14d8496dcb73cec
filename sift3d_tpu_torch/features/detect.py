"""Keypoint detection: GSS -> DoG -> extrema -> orientation.

Reproduces SIFT3D_detect_keypoints (reference sift3d/sift.c:1609-1641):
scale input to [-1, 1], build pyramids, detect extrema on DoG levels
s in [first_level+1, last_dog_level-1], assign orientations from the
corresponding gpyr levels, and compact rejected keypoints out while
preserving the reference's (octave, level, z, y, x) emission order.
"""

from __future__ import annotations

import torch

from ..config import SIFT3DParams
from ..dtypes import F64
from . import extrema, orientation
from .keypoints import Keypoints, concatenate


def _level_keypoints(zyx, R, ori_valid, o, s, sd) -> Keypoints:
    """Compact one level's keypoints after orientation rejection."""
    zyx = zyx[ori_valid]
    R = R[ori_valid]
    n = int(zyx.shape[0])
    dev = zyx.device
    return Keypoints(
        x=zyx[:, 2].to(F64), y=zyx[:, 1].to(F64), z=zyx[:, 0].to(F64),
        o=torch.full((n,), o, dtype=torch.int32, device=dev),
        s=torch.full((n,), s, dtype=torch.int32, device=dev),
        sd=torch.full((n,), sd, dtype=F64, device=dev),
        R=R.float(), count=n)


def kp_levels(plan):
    """The (o, s) levels that can hold keypoints (sift.c:1086-1089)."""
    s_start = plan.first_level + 1
    s_end = plan.last_dog_level - 1
    return [(o, s) for o in range(plan.num_octaves)
            for s in range(s_start, s_end + 1)]


def level_cap(plan, o: int, params: SIFT3DParams) -> int:
    """Extrema capacity for one level: the user cap (per-octave when
    ``max_kp_per_octave`` is set) clamped to the interior voxel count."""
    nx, ny, nz = plan.octave_dims(o)
    interior = max((nx - 2), 1) * max((ny - 2), 1) * max((nz - 2), 1)
    cap = params.max_kp_per_level
    if params.max_kp_per_octave:
        per_o = params.max_kp_per_octave
        cap = min(cap, per_o[min(o, len(per_o) - 1)])
    return min(cap, interior)


def detect_extrema_levels(dog: dict, plan, params: SIFT3DParams) -> dict:
    """Stage A: DoG extrema per level -> {(o, s): (zyx, count, total)}.

    ``total > count`` means rows were truncated at the level's capacity
    (the reference's keypoint slab is unbounded, so the loss is reported
    as ``kp_overflow``, never silent)."""
    return {(o, s): extrema.level_extrema(
        dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)],
        params.peak_thresh, level_cap(plan, o, params))
        for o, s in kp_levels(plan)}


def orient_levels(gpyr: dict, extrema_levels: dict, plan,
                  params: SIFT3DParams) -> Keypoints:
    """Stage B: orientation + compaction of every level's extrema."""
    buckets = []
    for o, s in kp_levels(plan):
        zyx = extrema_levels[(o, s)][0]
        geom = plan.gpyr_level(o, s)
        R, valid = orientation.assign_orientations_level(
            gpyr[(o, s)], zyx, geom.scale, plan.octave_units(o),
            params.corner_thresh)
        buckets.append(_level_keypoints(zyx, R, valid, o, s, geom.scale))
    return concatenate(buckets)
