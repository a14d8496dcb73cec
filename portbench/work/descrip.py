"""The work that kernel 1 (the descriptor windows) needs on a batch.

The operations per voxel are the port's kernel-1 counts when the
benchmark was written (``OPS_*``), frozen as the algorithm's work: per
core line of a window, the line's span in the sphere and the rotated bin
cube (42); per voxel in the sphere and the bin cube, up to the gradient
test (55); per voxel that also adds to a histogram, the face scan,
barycentrics, weights and 24 bin updates (161 more). The bytes: the union
of the windows (core and gradient halo) read once per volume, each row's
inputs read and its 768-bin histogram written once. Applied to the
keypoints that the plain reference finds on the same volumes.
"""

from __future__ import annotations

import torch

from ..reference.config import DESC_NUMEL
from ..reference.descrip import (_chunk_terms, _CHUNK_VOXELS,
                                 geometry_constants, level_buckets,
                                 level_geometry)
from ..reference.detect import detect
from ..reference.windows import batch_view, window_starts, window_union

OPS_LINE = 42
OPS_GEOMETRY_VOXEL = 55
OPS_CONTRIB_VOXEL = OPS_GEOMETRY_VOXEL + 161


def _active(level, centers, R, n, radii, cores, units, sigma, rad, vol):
    """(voxels that add to a histogram, voxels in the sphere and bin
    cube) of one bucket's first ``n`` rows."""
    g = geometry_constants(units, sigma, rad)
    box = cores[0] * cores[1] * cores[2]
    contrib = geometry = 0
    chunk = max(1, _CHUNK_VOXELS // box)
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        *_, ok, geom = _chunk_terms(level, vol[k0:k1],
                                    centers[k0:k1].float(),
                                    R[k0:k1].float(), radii, cores, units, g)
        contrib += int((geom & ok).sum())
        geometry += int(geom.sum())
    return contrib, geometry


def bucket_work(level, centers, R, radii, cores, units, sigma, rad,
                vol=None) -> tuple[float, float]:
    """(bytes, fp32 FLOP) of one level bucket's rows."""
    n = centers.shape[0]
    level, vol = batch_view(level, n, vol)
    starts = window_starts(level.shape[1:], torch.floor(centers).long(),
                           radii, cores)
    covered = window_union(level.shape, vol, starts, cores)
    contrib, geometry = _active(level, centers, R, n, radii, cores, units,
                                sigma, rad, vol)
    nbytes = 4 * covered + n * 4 * (1 + 3 + 3 + 9) + n * DESC_NUMEL * 4
    ops = (n * cores[0] * cores[1] * OPS_LINE + geometry * OPS_GEOMETRY_VOXEL
           + contrib * (OPS_CONTRIB_VOXEL - OPS_GEOMETRY_VOXEL))
    return float(nbytes), float(ops)


def descrip_work(vols, plan, params, device) -> tuple[float, float]:
    """(bytes, fp32 FLOP) of kernel 1 over a (B, nz, ny, nx) batch: the
    reference's detection, then every non-empty level bucket."""
    gpyr, kp, vol, _ = detect(vols, plan, params, device)
    nbytes = flops = 0.0
    for (o, s), rows in level_buckets(kp, plan):
        level = gpyr[(o, s)]
        sigma, rad, radii, cores = level_geometry(
            plan.gpyr_level(o, s).scale, plan.octave_units(o),
            level.shape[-3:])
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]],
                              -1).float()
        b, f = bucket_work(level, centers, kp.R[rows], radii, cores,
                           plan.octave_units(o), sigma, rad, vol[rows])
        nbytes += b
        flops += f
    return nbytes, flops
