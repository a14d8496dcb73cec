"""SIFT3D descriptor extraction.

Reproduces extract_descrip (reference sift3d/sift.c:1834-1928) and its
caller _SIFT3D_extract_descriptors (sift.c:2207-2243), as
``sift3d_tpu/features/descriptor.py`` does:

- window = sphere of radius 2 * sigma, sigma = sd * 5*sqrt(2), in real-world
  units around the keypoint (sift.c:1845-1846);
- displacements and Gaussian-weighted, unit-corrected gradients rotated
  into the keypoint frame by R^T, accumulated by trilinear spatial x
  3-vertex barycentric icosahedral interpolation into 4x4x4 x 12 bins
  (``ops/cuda_window.descrip_window``: the CUDA kernel on the card, its
  plain PyTorch version on the CPU);
- normalize -> truncate at 0.2*128/768 -> renormalize (sift.c:1794-1821,
  1909-1918); coordinates written back at base-octave scale (sift.c:1920).

Keypoints are bucketed by pyramid level: every keypoint of a level shares
its window geometry, and one kernel launch covers a bucket, across all the
volumes of a batch when the rows carry their volume index.
``extract_raw_descriptors`` runs the same buckets on one smoothed raw
image, with windows measured in base-octave voxels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import DESC_NUMEL, DESC_RAD_FCTR, DESC_SIG_FCTR, TRUNC_THRESH
from ..dtypes import F64
from ..ops.cuda_window import descrip_window
from ..utils import trace
from .dense import smooth_scale_raw_input
from .detect import kp_levels, level_cap
from .keypoints import Keypoints, valid_rows
from .windows import window_extent

_DBL_EPSILON = 2.220446049250313e-16


@dataclasses.dataclass
class Descriptors:
    """Descriptor set (reference SIFT3D_Descriptor, imtypes.h:291-296).
    Coordinates are in base-octave (image) space; rows >= count are
    padding. A set of a batch of volumes has a leading B axis on every
    field and a (B,) count tensor."""
    xyz: torch.Tensor   # (K, 3) f64
    sd: torch.Tensor    # (K,) f64
    vec: torch.Tensor   # (K, 768) f32
    count: int

    @property
    def capacity(self) -> int:
        return self.vec.shape[-2]

    def valid_mask(self) -> torch.Tensor:
        return valid_rows(self.capacity, self.count, self.vec.device)

    def to_numpy(self) -> np.ndarray:
        """Rows [x y z el0..el767] float32, trimmed to count: the
        reference CSV format (SIFT3D_Descriptor_store_to_Mat_rm,
        sift.c:2664-2717)."""
        n = self.count
        out = np.zeros((n, 3 + DESC_NUMEL), np.float32)
        out[:, :3] = self.xyz[:n].cpu().numpy()
        out[:, 3:] = self.vec[:n].cpu().numpy()
        return out


def postprocess(raw: torch.Tensor) -> torch.Tensor:
    """normalize -> truncate -> normalize (sift.c:1794-1821, 1909-1918)."""
    def normalize(v):
        norm = torch.sqrt(torch.sum(v.to(F64) ** 2, -1, keepdim=True)) \
            + _DBL_EPSILON
        return v * (1.0 / norm).float()
    v = normalize(raw)
    v = torch.clamp(v, max=TRUNC_THRESH)
    return normalize(v)


def level_geometry(sd: float, units, shape):
    """(sigma, rad, radii (z, y, x), cores (z, y, x)) of a level's
    descriptor windows (extract_level, sift.c:1845-1846)."""
    nz, ny, nx = shape
    sigma = np.float32(sd) * np.float32(DESC_SIG_FCTR)
    rad = np.float32(DESC_RAD_FCTR) * sigma
    Rx = int(math.ceil(float(rad) / units[0]))
    Ry = int(math.ceil(float(rad) / units[1]))
    Rz = int(math.ceil(float(rad) / units[2]))
    cores = (window_extent(Rz, nz, False), window_extent(Ry, ny, False),
             window_extent(Rx, nx, False))
    return float(sigma), float(rad), (Rz, Ry, Rx), cores


def extract_level(level: torch.Tensor, centers_zyx: torch.Tensor,
                  R: torch.Tensor, sd: float, units,
                  count: int | None = None,
                  vol: torch.Tensor | None = None) -> torch.Tensor:
    """Descriptors (K, 768) for all keypoints of one level; centers_zyx
    float (K, 3). Rows >= count (default K) are postprocessed zeros.
    ``level`` is (nz, ny, nx), or (B, nz, ny, nx) with the volume index
    ``vol`` (K,) of each row."""
    sigma, rad, radii, cores = level_geometry(sd, units, level.shape[-3:])
    if count is None:
        count = centers_zyx.shape[0]
    raw = descrip_window(level, centers_zyx, R, count, radii, cores, units,
                         sigma, rad, vol=vol)
    return postprocess(raw)


def level_buckets(kp: Keypoints, plan, stage: str = "descriptors"):
    """Yield ((o, s), rows) for every non-empty level bucket of ``kp``'s
    valid rows, rows in keypoint order, with one host sync for all
    buckets, counted as ``stage``'s (the sizes are counted on the device:
    ``torch.bincount`` would read its input's min and max on the host
    first)."""
    levels = kp_levels(plan)
    per_octave = len(levels) // plan.num_octaves
    n = kp.count
    o = kp.o[:n].long()
    s = kp.s[:n].long() - (plan.first_level + 1)
    on_level = (o >= 0) & (o < plan.num_octaves) & (s >= 0) & \
        (s < per_octave)
    # Index into ``levels``; rows on no keypoint level go to a last bucket.
    lid = torch.where(on_level, o * per_octave + s, len(levels))
    order = torch.argsort(lid, stable=True)
    sizes = torch.zeros(len(levels) + 1, dtype=torch.long,
                        device=lid.device).index_add_(0, lid,
                                                      torch.ones_like(lid))
    with trace.host_read(stage):
        sizes = sizes.tolist()
    start = 0
    for lv, size in zip(levels, sizes):
        if size:
            yield lv, order[start:start + size]
        start += size


def extract_descriptors(gpyr: dict, kp: Keypoints, plan,
                        vol: torch.Tensor | None = None) -> Descriptors:
    """Descriptors from the detection pyramid (SIFT3D_extract_descriptors,
    sift.c:2025-2046). Keypoint rows keep their order. With ``vol``, the
    (n,) volume index of each row, the ``gpyr`` levels are (B, nz, ny, nx)
    and each level bucket of all the volumes is one kernel launch."""
    vec = torch.zeros((kp.capacity, DESC_NUMEL), dtype=torch.float32,
                      device=kp.x.device)
    for (o, s), rows in level_buckets(kp, plan):
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        vec[rows] = extract_level(gpyr[(o, s)], centers, kp.R[rows],
                                  plan.gpyr_level(o, s).scale,
                                  plan.octave_units(o),
                                  vol=None if vol is None else vol[rows])
    factor = torch.exp2(kp.o.to(F64))
    xyz = torch.stack([kp.x * factor, kp.y * factor, kp.z * factor], -1)
    return Descriptors(xyz=xyz, sd=kp.sd, vec=vec, count=kp.count)


def raw_desc_args(smoothed: torch.Tensor, kp: Keypoints, plan, params,
                  units):
    """Yield ((o, s), rows, args) for every non-empty level bucket of the
    raw-image path: the bucket's first ``level_cap`` rows and the
    ``descrip_window`` arguments of its launch on the smoothed image,
    with centres in base-octave voxels, zyx * 2^o (float32), the
    bucket's sd and the base ``units``."""
    for (o, s), rows in level_buckets(kp, plan):
        rows = rows[:level_cap(plan, o, params)]
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        centers = centers * float(np.float32(2.0 ** o))
        sigma, rad, radii, cores = level_geometry(
            plan.gpyr_level(o, s).scale, units, smoothed.shape)
        yield (o, s), rows, (smoothed, centers, kp.R[rows], rows.shape[0],
                             radii, cores, units, sigma, rad, None)


def extract_raw_descriptors(vol: torch.Tensor, kp: Keypoints, units, plan,
                            params) -> Descriptors:
    """Descriptors from a raw (nz, ny, nx) image instead of a stored
    pyramid (SIFT3D_extract_raw_descriptors, reference sift.c:2131-2195).

    The image is smoothed from sigma_n to sigma0 and scaled to [-1, 1]
    (smooth_scale_raw_input, sift.c:1978-2006); keypoints go to the base
    octave by scaling their coordinates by 2^o with sd unchanged
    (keypoint2base / scale_Keypoint, sift.c:2094-2115, 1952-1967), so each
    (o, s) bucket keeps its own window size, now in base-octave voxels on
    the single smoothed image: one kernel launch per non-empty bucket
    (``raw_desc_args``). A bucket keeps its first ``level_cap`` rows, like
    the JAX package; the rest get zero descriptors.
    """
    smoothed = smooth_scale_raw_input(vol, units, params)
    vec = torch.zeros((kp.capacity, DESC_NUMEL), dtype=torch.float32,
                      device=smoothed.device)
    for _, rows, args in raw_desc_args(smoothed, kp, plan, params, units):
        vec[rows] = postprocess(descrip_window(*args))
    factor = torch.exp2(kp.o.to(F64))
    xyz = torch.stack([kp.x * factor, kp.y * factor, kp.z * factor], -1)
    return Descriptors(xyz=xyz, sd=kp.sd, vec=vec, count=kp.count)
