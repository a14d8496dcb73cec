"""Keypoint detection: GSS -> DoG -> extrema -> orientation.

Reproduces SIFT3D_detect_keypoints (reference sift3d/sift.c:1609-1641):
scale input to [-1, 1], build pyramids, detect extrema on DoG levels
s in [first_level+1, last_dog_level-1], assign orientations from the
corresponding gpyr levels, and compact rejected keypoints out while
preserving the reference's (octave, level, z, y, x) emission order.

Detection runs on a (B, nz, ny, nx) batch of volumes of one shape (one
volume is a batch of one): each level is one set of launches for the
whole batch, and its keypoint rows carry their volume index; orientation
is one launch for every level.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import pyramid as pyr_mod
from ..config import SIFT3DParams
from ..dtypes import F64
from ..ops.upload import upload_parts
from ..utils import trace
from . import extrema, orientation
from .keypoints import Keypoints


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
    """Stage A: DoG extrema per level -> {(o, s): (zyx, count, total)}
    (``extrema.level_extrema``'s forms for one volume or a batch), every
    level in one ``extrema.extrema_levels`` call (one host read).

    ``total > count`` means rows were truncated at the level's capacity
    (the reference's keypoint slab is unbounded, so the loss is reported
    as ``kp_overflow``, never silent)."""
    return dict(zip(kp_levels(plan), extrema.extrema_levels(
        extrema_args(dog, plan, params), params.peak_thresh)))


def extrema_args(dog: dict, plan, params: SIFT3DParams) -> list:
    """``extrema.extrema_levels``' levels of a detection: (prev, cur, nxt,
    capacity) of each keypoint level, in ``kp_levels`` order."""
    return [(dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)],
             level_cap(plan, o, params)) for o, s in kp_levels(plan)]


def keypoint_levels(gpyr: dict, extrema_levels: dict, plan):
    """Per keypoint level, in ``kp_levels`` order, (level, extrema rows
    (n, 4), sd, units): ``orientation.assign_orientations_levels``'
    input."""
    return [(gpyr[(o, s)], extrema_levels[(o, s)][0],
             plan.gpyr_level(o, s).scale, plan.octave_units(o))
            for o, s in kp_levels(plan)]


def orient_levels(gpyr: dict, extrema_levels: dict, plan,
                  params: SIFT3DParams):
    """Stage B: orientation + compaction of every level's extrema, over a
    batch: ``gpyr`` levels (B, nz, ny, nx) and ``extrema_levels`` in the
    batch form ((n, 4) rows (volume, z, y, x)).

    One orientation launch covers every level and every volume. Returns
    (kp, vol): the kept keypoints of all volumes in (level, volume, scan)
    order, with count == capacity, and the (n,) volume index of each row.
    """
    levels = keypoint_levels(gpyr, extrema_levels, plan)
    rows, R, valid = orientation.assign_orientations_levels(
        levels, params.corner_thresh)
    return keypoints_from_rows(rows, R, valid,
                               [r.shape[0] for _, r, _, _ in levels], plan)


def keypoints_from_rows(rows, R, valid, sizes, plan):
    """The kept keypoints of oriented extrema rows: ``rows`` (n, 4)
    (volume, z, y, x), ``R`` (n, 3, 3) and ``valid`` (n,) of every level
    in ``kp_levels`` order, ``sizes`` the rows of each level. Returns
    ``orient_levels``' (kp, vol)."""
    with trace.host_read("orientation"):
        keep = torch.nonzero(valid).reshape(-1)
    trace.count("orientation.kept", keep.shape[0])
    # Each row's (o, s, sd), from the (levels, 4) table of (o, s, sd, rows)
    # copied once.
    table = torch.tensor([(o, s, plan.gpyr_level(o, s).scale, n)
                          for (o, s), n in zip(kp_levels(plan), sizes)],
                         dtype=F64, device=rows.device)
    per_row = torch.repeat_interleave(table[:, :3], table[:, 3].long(), 0,
                                      output_size=rows.shape[0])[keep]
    rows, R = rows[keep], R[keep]
    kp = Keypoints(x=rows[:, 3].to(F64), y=rows[:, 2].to(F64),
                   z=rows[:, 1].to(F64), o=per_row[:, 0].to(torch.int32),
                   s=per_row[:, 1].to(torch.int32), sd=per_row[:, 2],
                   R=R.float(), count=int(keep.shape[0]))
    return kp, rows[:, 0].long()


def detect(vols, plan, params: SIFT3DParams, device,
           pipelined: bool = False):
    """Detect keypoints in a (B, nz, ny, nx) batch of raw volumes.

    Returns (gpyr, kp, vol, kp_overflow): the Gaussian pyramid
    {(o, s): (B, nz, ny, nx)}, ``orient_levels``' keypoints and volume
    index, and the (B,) flag of volumes whose extrema exceeded a level's
    capacity. ``pipelined`` builds the pyramid with
    ``pyramid.build_gpyr_pipelined``. The volumes come to ``device``
    through ``ops/upload.upload_parts`` (``vols`` may be the Pending of
    ``upload_start``): a host stack that streams is built sub-batch by
    sub-batch as each lands, into its slice of the batch's levels. Each
    wait for a copy runs in a ``sift3d.upload`` span, each pyramid
    build in ``sift3d.pyramid``, and each stage after them inside a
    ``sift3d.<stage>`` profiler span.
    """
    gpyr, dog = {}, {}
    with upload_parts(vols, device, torch.float32) as (n, parts):
        for sl, x in parts:
            with record_function("sift3d.pyramid"):
                pyr_mod.build_into(gpyr, dog, x, sl, n, plan, pipelined)
    with record_function("sift3d.extrema"):
        ext = detect_extrema_levels(dog, plan, params)
    with record_function("sift3d.orientation"):
        kp, vol = orient_levels(gpyr, ext, plan, params)
    return gpyr, kp, vol, overflow_flags(ext)


def overflow_flags(extrema_levels: dict) -> torch.Tensor:
    """(B,) flag of the volumes whose extrema exceeded a level's capacity
    (batch-form ``extrema_levels``)."""
    return torch.stack([total > count for _, count, total
                        in extrema_levels.values()]).any(0)
