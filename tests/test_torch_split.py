"""The descriptor-window kernel's decomposition, in plain PyTorch and numpy.

The kernel (``csrc/descrip_window.cu``) splits each row's window into
z-slabs handled by separate blocks (``slab_plan``), sums the slabs' partial
histograms in slab order, and walks each (z, y) line only over its span cut
to the sphere and the rotated bin cube (``line_span``). These tests hold the plan, the split and the
span rule on the CPU; ``tests/test_torch_kernels.py`` holds the kernel
itself against the plain version on the card.
"""

import math

import numpy as np
import pytest
import torch

from sift3d_tpu_torch.config import DESC_NUMEL, DESC_RAD_FCTR, DESC_SIG_FCTR
from sift3d_tpu_torch.features.windows import window_extent, window_starts
from sift3d_tpu_torch.ops.cuda_window import (NUM_SMS, OPS_CONTRIB_VOXEL,
                                              OPS_GEOMETRY_VOXEL, OPS_LINE,
                                              descrip_active,
                                              descrip_window_plain,
                                              descrip_work,
                                              geometry_constants, line_span,
                                              slab_plan)

torch.set_num_threads(1)


@pytest.mark.parametrize("rows", [1, 3, 25, 131, 264, 3000])
@pytest.mark.parametrize("cz", [1, 7, 40, 74])
def test_slab_plan_covers_each_plane_once(rows, cz):
    planes, slabs = slab_plan(rows, cz)
    hits = np.zeros((rows, cz), int)
    for k in range(rows):
        for s in range(slabs):
            z0 = s * planes
            assert z0 < cz, "empty slab"
            hits[k, z0:min(cz, z0 + planes)] += 1
    assert (hits == 1).all()
    blocks = rows * slabs
    if rows * cz >= 2 * NUM_SMS:
        assert blocks >= 2 * NUM_SMS
    else:
        assert slabs == cz
    if rows >= 2 * NUM_SMS:
        assert slabs == 1
    scratch = rows * slabs * DESC_NUMEL if slabs > 1 else 0
    assert scratch <= blocks * DESC_NUMEL


def _rows(rng, shape, K, units, sd):
    centers = torch.as_tensor(np.stack(
        [rng.uniform(2, n - 3, K) for n in shape], -1).astype(np.float32))
    R = torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                  rng.standard_normal((K, 3, 3))],
                                 np.float32))
    sigma = float(np.float32(sd) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units[::-1])
    cores = tuple(window_extent(r, n, False) for r, n in zip(radii, shape))
    return centers, R, (radii, cores, units, sigma, rad)


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8)])
def test_slab_split_equals_unsplit(units):
    """descrip_window_plain split into the kernel's slabs (and a few other
    depths) equals the unsplit histograms within 1e-5 of each row's
    largest bin."""
    rng = np.random.default_rng(5)
    shape = (30, 34, 28)
    level = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    K, count = 5, 4
    centers, R, geom = _rows(rng, shape, K, units, 1.2)
    cz = geom[1][0]
    want = descrip_window_plain(level, centers, R, count, *geom)
    plan_planes = slab_plan(count, cz)[0]
    assert plan_planes < cz, "the plan must split at this row count"
    for planes in sorted({plan_planes, 2, 5, cz}):
        got = descrip_window_plain(level, centers, R, count, *geom,
                                   planes=planes)
        assert torch.all(got[count:] == 0)
        scale = want.abs().amax(1, keepdim=True)
        assert ((got - want).abs() <= 1e-5 * scale).all(), planes


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8),
                                   (0.7, 0.7, 2.5)])
def test_line_span_keeps_every_window_voxel(units):
    """The kernel's x-span of a line never drops a voxel that passes the
    exact fp32 sphere and bin-cube tests (the kernel's and the plain
    version's rounding), over 200 random centres and rotations."""
    f = np.float32
    rng = np.random.default_rng(11)
    ux, uy, uz = (f(u) for u in units)
    kept = total = 0
    for _ in range(200):
        sigma = float(rng.uniform(1.0, 2.8))
        rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
        g = geometry_constants(units, sigma, rad)
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(f)
        radii = [int(math.ceil(rad / u)) for u in (units[2], units[1],
                                                   units[0])]
        c = [f(rng.uniform(r + 2, r + 40)) for r in radii]
        cores = [2 * r + 2 for r in radii]
        starts = [int(np.floor(cc)) - r for cc, r in zip(c, radii)]
        x = np.arange(starts[2], starts[2] + cores[2])
        vx = (x.astype(f) - c[2]) * ux
        for z in range(starts[0], starts[0] + cores[0]):
            vz = (f(z) - c[0]) * uz
            for y in range(starts[1], starts[1] + cores[1]):
                vy = (f(y) - c[1]) * uy
                sq = (vx * vx + vy * vy) + vz * vz
                ok = sq <= f(g["rad2"])
                for i in range(3):
                    k = (R[0, i] * vx + R[1, i] * vy) + R[2, i] * vz
                    vb = (k + f(g["half_width"])) * f(g["bin_fctr"])
                    ok &= (vb >= 0) & (vb < 4)
                inside = x[ok]
                total += inside.size
                span = line_span(c, y, z, R, g, starts[2], cores[2])
                if span is None:
                    assert inside.size == 0, (z, y)
                    continue
                assert ((inside >= span[0]) & (inside <= span[1])).all()
                kept += span[1] - span[0] + 1
    # The cut keeps little more than the voxels that pass.
    assert total > 0 and kept < 2.0 * total


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8)])
def test_descrip_active_counts(units):
    """The bound's voxel counts: the voxels in the sphere and rotated bin
    cube equal a numpy count of the same fp32 tests; on a flat level none
    adds to a bin, on a rough one nearly all do; the operations follow
    the per-line and per-voxel counts."""
    f = np.float32
    rng = np.random.default_rng(9)
    shape = (30, 34, 28)
    K, count = 4, 3
    centers, R, geom = _rows(rng, shape, K, units, 1.2)
    radii, cores = geom[0], geom[1]
    g = geometry_constants(*geom[2:])
    starts = window_starts(shape, torch.floor(centers).long(), radii,
                           cores).numpy()
    want = 0
    for k in range(count):
        axes = [(np.arange(s0, s0 + n).astype(f) - f(c)) * f(u)
                for s0, n, c, u in zip(starts[k], cores, centers[k].numpy(),
                                       units[::-1])]
        vz, vy, vx = np.meshgrid(*axes, indexing="ij")
        ok = (vx * vx + vy * vy) + vz * vz <= f(g["rad2"])
        Rk = R[k].numpy()
        for i in range(3):
            kk = (Rk[0, i] * vx + Rk[1, i] * vy) + Rk[2, i] * vz
            vb = (kk + f(g["half_width"])) * f(g["bin_fctr"])
            ok &= (vb >= 0) & (vb < 4)
        want += int(ok.sum())
    boxes = count * cores[0] * cores[1] * cores[2]
    flat = torch.zeros(shape)
    assert descrip_active(flat, centers, R, count, *geom) == (0, want, boxes)
    rough = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    contrib, geometry, n_box = descrip_active(rough, centers, R, count, *geom)
    assert geometry == want > 0 and n_box == boxes
    assert 0.99 * geometry <= contrib <= geometry
    _, ops, *counts = descrip_work(rough, centers, R, count, *geom)
    assert counts == [contrib, geometry, boxes]
    assert ops == (count * cores[0] * cores[1] * OPS_LINE +
                   (geometry - contrib) * OPS_GEOMETRY_VOXEL +
                   contrib * OPS_CONTRIB_VOXEL)
