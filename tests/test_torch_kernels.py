"""The port's CUDA kernels against their plain PyTorch versions.

These need the card (the kernels are built with nvcc for sm_90a and have
no CPU mode) and skip elsewhere; on a machine with the card run
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (this
file needs no JAX, which ``tests/conftest.py`` imports). ``chip_smoke.py``
repeats the checks at the shapes of a 256^3 registration and of a
config-4 batch.
"""

import math

import numpy as np
import pytest
import torch

from sift3d_tpu_torch.config import DESC_RAD_FCTR, DESC_SIG_FCTR
from sift3d_tpu_torch.features.descriptor import postprocess
from sift3d_tpu_torch.features.match import nn_match
from sift3d_tpu_torch.features.orientation import level_geometry
from sift3d_tpu_torch.features.windows import window_extent
from sift3d_tpu_torch.ops import cuda_match, cuda_orient, cuda_window
from sift3d_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _level(rng, shape):
    nz, ny, nx = shape
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    vol = np.zeros(shape)
    for _ in range(30):
        c = rng.uniform(0, nz, 3)
        s = rng.uniform(1.5, 4.0)
        vol += rng.uniform(-1, 1) * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
            / (2 * s * s))
    return vol.astype(np.float32)


def _thin_level(rng, shape):
    """Blobs centred inside every axis: a level thin in y and x (the F1
    shapes) with structure all along z."""
    grids = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    vol = np.zeros(shape)
    for _ in range(shape[0] // 8):
        c = [rng.uniform(0, n) for n in shape]
        s = rng.uniform(1.5, 4.0)
        vol += rng.uniform(-1, 1) * np.exp(
            -sum((g - a) ** 2 for g, a in zip(grids, c)) / (2 * s * s))
    return vol.astype(np.float32)


def _descrip_args(rng, shape, K, units):
    centers = torch.as_tensor(np.stack(
        [rng.uniform(2, n - 3, K) for n in shape], -1).astype(np.float32))
    R = torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                  rng.standard_normal((K, 3, 3))],
                                 np.float32))
    sd = 1.6
    sigma = float(np.float32(sd) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units[::-1])
    cores = tuple(window_extent(r, n, False) for r, n in zip(radii, shape))
    return centers, R, (radii, cores, units, sigma, rad)


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8)])
def test_descrip_window_kernel_matches_plain(cuda, units):
    rng = np.random.default_rng(0)
    shape = (40, 44, 36)
    level = torch.as_tensor(_level(rng, shape))
    K, count = 24, 20
    centers, R, geom = _descrip_args(rng, shape, K, units)
    want = cuda_window.descrip_window(level, centers, R, count, *geom)
    before = trace.counters().get("launches.descrip_window", 0)
    got = cuda_window.descrip_window(level.to(cuda), centers.to(cuda),
                                     R.to(cuda), count, *geom)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.descrip_window", 0) == before + 1
    got = got.cpu()
    assert torch.all(got[count:] == 0)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


def test_descrip_window_kernel_batched(cuda):
    """Rows of three volumes in one launch equal the per-volume plain
    calls."""
    rng = np.random.default_rng(3)
    shape, units = (36, 40, 32), (1.0, 1.3, 0.8)
    levels = torch.as_tensor(np.stack([_level(rng, shape) for _ in range(3)]))
    K = 18
    centers, R, geom = _descrip_args(rng, shape, K, units)
    vol = torch.as_tensor(rng.integers(0, 3, K))
    want = torch.zeros((K, 768))
    for b in range(3):
        m = vol == b
        want[m] = cuda_window.descrip_window_plain(
            levels[b], centers[m], R[m], int(m.sum()), *geom)
    before = trace.counters().get("launches.descrip_window", 0)
    got = cuda_window.descrip_window(levels.to(cuda), centers.to(cuda),
                                     R.to(cuda), K, *geom, vol=vol.to(cuda))
    torch.cuda.synchronize()
    assert trace.counters().get("launches.descrip_window", 0) == before + 1
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8)])
def test_orient_window_kernel_matches_plain(cuda, units):
    """Kernel 3 on rows of three volumes, windows clamped at both edges,
    and rows past count."""
    rng = np.random.default_rng(4)
    shape = (24, 28, 20)
    levels = torch.as_tensor(np.stack([_level(rng, shape) for _ in range(3)]))
    K, count = 16, 13
    zyx = np.stack([rng.integers(1, n - 1, K) for n in shape], -1)
    zyx[0] = (1, 1, 1)
    zyx[1] = tuple(n - 2 for n in shape)
    zyx = torch.as_tensor(zyx)
    vol = torch.as_tensor(rng.integers(0, 3, K))
    sigma, rad, radii, cores = level_geometry(1.6, units, shape)
    args = (count, radii, cores, units, sigma, rad)
    A_want, vd_want = cuda_orient.orient_terms_plain(levels, zyx, *args,
                                                     vol=vol)
    before = trace.counters().get("launches.orient_window", 0)
    A_got, vd_got = cuda_orient.orient_terms(levels.to(cuda), zyx.to(cuda),
                                             *args, vol=vol.to(cuda))
    torch.cuda.synchronize()
    assert trace.counters().get("launches.orient_window", 0) == before + 1
    assert A_got.dtype == torch.float64 and vd_got.dtype == torch.float32
    A_got, vd_got = A_got.cpu(), vd_got.cpu()
    assert torch.all(A_got[count:] == 0) and torch.all(vd_got[count:] == 0)
    scale = torch.cat([A_want.abs(), vd_want.abs().double()], 1).amax(1,
                                                                      True)
    assert ((A_got - A_want).abs() <= 1e-5 * scale).all()
    assert ((vd_got - vd_want).abs().double() <= 1e-5 * scale).all()


def test_orient_window_kernel_levels_one_launch(cuda):
    """Kernel 3 over three levels of different shapes (one anisotropic, one
    clamped to n - 2) and three volumes in one launch, with rows past each
    level's count: within 1e-5 of each row's largest term of the plain
    version, and a second launch gives the same bits."""
    rng = np.random.default_rng(6)
    specs = [((24, 28, 20), (1.0, 1.0, 1.0), 1.6, 40, 33),
             ((18, 16, 22), (1.0, 1.3, 0.8), 1.5, 25, 25),
             ((8, 8, 8), (2.0, 2.0, 2.0), 3.2, 9, 6)]
    rows, args = [], []
    for shape, units, sd, n, count in specs:
        levels = torch.as_tensor(np.stack([_level(rng, shape)
                                           for _ in range(3)]))
        zyx = np.stack([rng.integers(1, m - 1, n) for m in shape], -1)
        zyx[0] = (1, 1, 1)
        zyx[1] = tuple(m - 2 for m in shape)
        vol = rng.integers(0, 3, n)
        rows.append(np.concatenate([vol[:, None], zyx], 1))
        sigma, rad, radii, cores = level_geometry(sd, units, shape)
        args.append((levels, n, count, radii, cores, units, sigma, rad))
    rows = torch.as_tensor(np.concatenate(rows).astype(np.int32))
    A_want, vd_want = cuda_orient.orient_terms_levels(rows, args)
    args_d = [(a[0].to(cuda), *a[1:]) for a in args]
    before = trace.counters().get("launches.orient_window", 0)
    A_got, vd_got = cuda_orient.orient_terms_levels(rows.to(cuda), args_d)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.orient_window", 0) == before + 1
    A2, vd2 = cuda_orient.orient_terms_levels(rows.to(cuda), args_d)
    torch.cuda.synchronize()
    assert torch.equal(A_got, A2) and torch.equal(vd_got, vd2)
    A_got, vd_got = A_got.cpu(), vd_got.cpu()
    r0 = 0
    for _, n, count, *_ in args:
        assert not A_got[r0 + count:r0 + n].any()
        assert not vd_got[r0 + count:r0 + n].any()
        r0 += n
    scale = torch.cat([A_want.abs(), vd_want.abs().double()], 1).amax(1,
                                                                      True)
    assert ((A_got - A_want).abs() <= 1e-5 * scale).all()
    assert ((vd_got - vd_want).abs().double() <= 1e-5 * scale).all()
    dev = torch.cat([(A_got - A_want).abs(),
                     (vd_got - vd_want).abs().double()], 1)
    print(f"orient levels: max rel dev "
          f"{(dev / scale.clamp(min=1e-300)).max().item():.3e}")


def _rel_dev(got, want):
    """Largest deviation of the kernel's (A6, vd) from the plain version's,
    relative to each row's largest |term|."""
    scale = torch.cat([want[0].abs(), want[1].abs().double()], 1).amax(1,
                                                                       True)
    dev = torch.cat([(got[0].cpu() - want[0]).abs(),
                     (got[1].cpu() - want[1]).abs().double()], 1)
    return (dev / scale.clamp(min=1e-300)).max().item()


def test_orient_window_kernel_more_levels_than_a_launch(cuda):
    """35 levels with rows (and two without) take two launches, one per
    group of MAX_LEVELS: within 1e-5 of the plain version."""
    rng = np.random.default_rng(9)
    rows, args = [], []
    for i in range(37):
        shape = (10 + i % 4, 12 - i % 3, 9 + i % 5)
        units = (1.0, 1.0, 1.0) if i % 2 else (1.0, 1.3, 0.8)
        n = 0 if i in (3, 20) else 2 + i % 4
        levels = torch.as_tensor(np.stack([_level(rng, shape)
                                           for _ in range(2)]))
        zyx = np.stack([rng.integers(1, m - 1, n) for m in shape], -1)
        vol = rng.integers(0, 2, n)
        rows.append(np.concatenate([vol[:, None], zyx], 1))
        sigma, rad, radii, cores = level_geometry(1.2 + 0.05 * i, units,
                                                  shape)
        args.append((levels, n, max(n - i % 2, 0), radii, cores, units,
                     sigma, rad))
    assert len(cuda_orient.level_groups(args)) == 2
    rows = torch.as_tensor(np.concatenate(rows).astype(np.int32))
    want = cuda_orient.orient_terms_levels_plain(rows, args)
    args_d = [(a[0].to(cuda), *a[1:]) for a in args]
    before = trace.counters().get("launches.orient_window", 0)
    got = cuda_orient.orient_terms_levels(rows.to(cuda), args_d)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.orient_window", 0) == before + 2
    assert _rel_dev(got, want) <= 1e-5


def test_orient_window_kernel_noncontiguous_levels(cuda):
    """Two levels that are slices of larger tensors (the wrapper makes
    contiguous copies and holds them until the launch) in one launch."""
    rng = np.random.default_rng(10)
    big = torch.as_tensor(np.stack([_level(rng, (26, 30, 28))
                                    for _ in range(3)]))
    levels = [big[:, 1:25, 2:28, 3:23], big.transpose(2, 3)[:, :, :22]]
    rows, args = [], []
    for lv, units in zip(levels, [(1.0, 1.0, 1.0), (1.0, 1.3, 0.8)]):
        shape = tuple(lv.shape[1:])
        zyx = np.stack([rng.integers(1, m - 1, 12) for m in shape], -1)
        vol = rng.integers(0, 3, 12)
        rows.append(np.concatenate([vol[:, None], zyx], 1))
        sigma, rad, radii, cores = level_geometry(1.6, units, shape)
        args.append((lv, 12, 12, radii, cores, units, sigma, rad))
    rows = torch.as_tensor(np.concatenate(rows).astype(np.int32))
    want = cuda_orient.orient_terms_levels_plain(rows, args)
    big_d = big.to(cuda)
    args_d = [(big_d[:, 1:25, 2:28, 3:23], *args[0][1:]),
              (big_d.transpose(2, 3)[:, :, :22], *args[1][1:])]
    assert not any(a[0].is_contiguous() for a in args_d)
    got = cuda_orient.orient_terms_levels(rows.to(cuda), args_d)
    torch.cuda.synchronize()
    assert _rel_dev(got, want) <= 1e-5


def test_match_kernel_matches_plain_and_dense(cuda):
    rng = np.random.default_rng(1)
    d1 = rng.random((700, 768)).astype(np.float32)
    d2 = rng.random((650, 768)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    for i in range(200):
        d2[(i * 3) % 650] = d1[i] + rng.normal(0, 0.004, 768)
    d2[600] = d2[3]
    d1[650] = d1[7]
    v1 = torch.ones(700, dtype=torch.bool)
    v1[[5, 600]] = False
    v2 = torch.ones(650, dtype=torch.bool)
    v2[[11]] = False
    t1, t2 = torch.as_tensor(d1), torch.as_tensor(d2)
    inf = float("inf")
    qsq = torch.where(v1, torch.sum(t1 * t1, 1), inf)
    tsq = torch.where(v2, torch.sum(t2 * t2, 1), inf)
    plain = cuda_match.reduce_one_way_plain(t1, t2, qsq, tsq)
    before = trace.counters().get("launches.match_stream", 0)
    got = cuda_match.reduce_one_way(t1.to(cuda), t2.to(cuda), qsq.to(cuda),
                                    tsq.to(cuda))
    torch.cuda.synchronize()
    assert trace.counters().get("launches.match_stream", 0) == before + 1
    np.testing.assert_array_equal(got[2].cpu().numpy(), plain[2].numpy())
    for a, b in zip(got[:2], plain[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    m_stream = cuda_match.nn_match_streamed(t1.to(cuda), t2.to(cuda), 0.8,
                                            v1.to(cuda), v2.to(cuda))
    m_dense = nn_match(t1.to(cuda), t2.to(cuda), 0.8, v1.to(cuda),
                       v2.to(cuda))
    np.testing.assert_array_equal(m_stream.cpu().numpy(),
                                  m_dense.cpu().numpy())


def test_descrip_window_kernel_slab_split(cuda):
    """One row with a window of a 256^3 registration's finest level (rad
    about 35 voxels): the launch splits it into z-slabs whose partials are
    summed by the merge pass; against the plain version."""
    rng = np.random.default_rng(6)
    shape = (80, 84, 78)
    level = torch.as_tensor(_level(rng, shape))
    units = (1.0, 1.0, 1.0)
    sigma = float(np.float32(2.475) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units)
    cores = tuple(window_extent(r, n, False) for r, n in zip(radii, shape))
    assert 34 <= rad <= 36
    assert cuda_window.slab_plan(1, cores[0])[1] > 1
    centers = torch.tensor([[40.3, 41.7, 38.2], [10.0, 10.0, 10.0]])
    R = torch.as_tensor(np.linalg.qr(rng.standard_normal((3, 3)))[0],
                        dtype=torch.float32).expand(2, 3, 3)
    geom = (radii, cores, units, sigma, rad)
    want = cuda_window.descrip_window_plain(level, centers, R, 1, *geom)
    before = trace.counters().get("launches.descrip_window", 0)
    got = cuda_window.descrip_window(level.to(cuda), centers.to(cuda),
                                     R.to(cuda), 1, *geom)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.descrip_window", 0) == before + 1
    got = got.cpu()
    assert torch.all(got[1:] == 0)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("contrast, offset", [(1e-4, 0.0), (1e-5, 0.0),
                                              (1e-5, 0.5)])
def test_descrip_window_kernel_dark_window(cuda, contrast, offset):
    """A window whose gradients lie 1e-4 to 1e-5 below the level's largest
    value (a bright blob elsewhere; with ``offset``, the window also sits
    on a bright flat background), as soft tissue beside bone in CT: the
    kernel's fixed-point sums hold each row against the plain version, in
    a launch split into z-slabs beside a row over the bright blob."""
    rng = np.random.default_rng(7)
    shape = (64, 64, 64)
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    bright = np.exp(-((z - 5) ** 2 + (y - 5) ** 2 + (x - 5) ** 2) / 8.0)
    level = torch.as_tensor((_level(rng, shape) +
                             (offset + bright) / contrast).astype(np.float32))
    units = (1.0, 1.0, 1.0)
    sigma = float(np.float32(1.6) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units)
    cores = tuple(window_extent(r, n, False) for r, n in zip(radii, shape))
    assert cuda_window.slab_plan(2, cores[0])[1] > 1
    centers = torch.tensor([[40.3, 41.7, 38.2], [10.4, 9.6, 10.1]])
    R = torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                  rng.standard_normal((2, 3, 3))],
                                 np.float32))
    geom = (radii, cores, units, sigma, rad)
    want = cuda_window.descrip_window_plain(level, centers, R, 2, *geom)
    got = cuda_window.descrip_window(level.to(cuda), centers.to(cuda),
                                     R.to(cuda), 2, *geom).cpu()
    assert (want[0] != 0).sum() > 100
    rel = ((got - want).abs().amax(1) / want.abs().amax(1)).tolist()
    dev = (postprocess(got) - postprocess(want)).abs().max().item()
    print(f"dark window {contrast:g}, offset {offset:g}: max |dev| of the "
          f"raw rows over each row's largest bin {rel}, of the descriptors "
          f"{dev:.3e}")
    assert dev <= 2e-3
    assert max(rel) <= 1e-4


def test_match_kernel_split_ranges(cuda):
    """128 x 128 tiles over 18 target ranges: duplicated targets in
    different ranges and invalid rows; indices exact against the plain
    version (unsplit and split the kernel's way) and the dense matcher."""
    rng = np.random.default_rng(2)
    n1, n2 = 2500, 2300
    d1 = rng.random((n1, 768)).astype(np.float32)
    d2 = rng.random((n2, 768)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    for i in range(300):
        d2[(i * 7) % 1900] = d1[i] + rng.normal(0, 0.004, 768)
    d2[2000:2010] = d2[0:70:7]        # duplicates of planted targets
    d1[2400:2405] = d1[:5]
    side, per, ranges = cuda_match.match_plan(n1, n2)
    bounds = list(range(0, n2, side * per))
    assert side == 128 and ranges > 1
    assert np.searchsorted(bounds, 63, "right") != \
        np.searchsorted(bounds, 2009, "right")
    v1 = torch.ones(n1, dtype=torch.bool)
    v1[[3, 1700, 2499]] = False
    v2 = torch.ones(n2, dtype=torch.bool)
    v2[[5, 2299]] = False
    t1, t2 = torch.as_tensor(d1), torch.as_tensor(d2)
    inf = float("inf")
    qsq = torch.where(v1, torch.sum(t1 * t1, 1), inf)
    tsq = torch.where(v2, torch.sum(t2 * t2, 1), inf)
    plain = cuda_match.reduce_one_way_plain(t1, t2, qsq, tsq)
    split = cuda_match.reduce_one_way_plain(t1, t2, qsq, tsq, bounds=bounds)
    got = cuda_match.reduce_one_way(t1.to(cuda), t2.to(cuda), qsq.to(cuda),
                                    tsq.to(cuda))
    torch.cuda.synchronize()
    for want in (plain, split):
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].numpy())
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert not np.isin(got[2].cpu().numpy(), np.arange(2000, 2010)).any()
    m_stream = cuda_match.nn_match_streamed(t1.to(cuda), t2.to(cuda), 0.8,
                                            v1.to(cuda), v2.to(cuda))
    m_dense = nn_match(t1.to(cuda), t2.to(cuda), 0.8, v1.to(cuda),
                       v2.to(cuda))
    np.testing.assert_array_equal(m_stream.cpu().numpy(),
                                  m_dense.cpu().numpy())
    assert (m_dense >= 0).sum() >= 100


@pytest.mark.parametrize("shape,units,sd,wide", [
    ((40, 40, 300), (0.25, 1.0, 1.0), 8.0, 1),     # x extent 144
    ((160, 160, 160), (1.0, 1.0, 1.0), 30.0, 3),   # every extent 135
])
def test_orient_window_kernel_wide_extents(cuda, shape, units, sd, wide):
    """Kernel 3 on levels whose offset tables reach past 127 voxels on one
    axis and on all three (the raw-image path's windows): rows in the
    middle, at both corners and past count, against the plain version."""
    rng = np.random.default_rng(11)
    level = torch.as_tensor(_level(rng, shape)).to(cuda)
    sigma, rad, radii, cores = level_geometry(sd, units, shape)
    ext = cuda_orient.table_extents(radii, cores)
    assert sum(e > 127 for e in ext) == wide, ext
    zyx = np.stack([rng.integers(1, n - 1, 6) for n in shape], -1)
    zyx[0] = (1, 1, 1)
    zyx[1] = tuple(n - 2 for n in shape)
    zyx[2] = tuple(n // 2 for n in shape)
    zyx = torch.as_tensor(zyx).to(cuda)
    args = (5, radii, cores, units, sigma, rad)
    want = cuda_orient.orient_terms_plain(level, zyx[:5], *args)
    before = trace.counters().get("launches.orient_window", 0)
    got = cuda_orient.orient_terms(level, zyx, *args)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.orient_window", 0) == before + 1
    assert not got[0][5:].any() and not got[1][5:].any()
    rel = _rel_dev((got[0][:5], got[1][:5]), (want[0].cpu(), want[1].cpu()))
    print(f"orient wide extents {ext}: max rel dev {rel:.3e}")
    assert rel <= 1e-5


def test_orient_window_kernel_tables_past_the_cache(cuda, monkeypatch):
    """Kernel 3 on a 256^3 level with offset tables of 0.6-1.2 GiB (the
    raw-image path's octave-5 windows, which walk their boxes unless
    BOX_WALK_ENTRIES is raised as here): a table larger than
    TABLE_CACHE_BYTES is built for its call and not kept; of two that do
    not fit together the older is evicted, and built again when it is met
    again. Each call against the plain version."""
    monkeypatch.setattr(cuda_orient, "_statics", cuda_orient._TableCache(
        cuda_orient.TABLE_CACHE_BYTES))
    monkeypatch.setattr(cuda_orient, "BOX_WALK_ENTRIES", 1 << 27)
    cache = cuda_orient._statics
    shape, units = (256,) * 3, (1.0, 1.0, 1.0)
    gen = torch.Generator(device=cuda).manual_seed(13)
    z, y, x = torch.meshgrid(*(torch.arange(n, device=cuda,
                                            dtype=torch.float32)
                               for n in shape), indexing="ij")
    level = 0.01 * torch.rand(shape, device=cuda, generator=gen)
    for c, s, a in (((60, 90, 200), 30.0, 1.0), ((180, 150, 70), 45.0, -0.7),
                    ((128, 20, 128), 20.0, 0.5)):
        level += a * torch.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 +
                                 (x - c[2]) ** 2) / (2 * s * s))
    zyx = torch.tensor([[128, 128, 128], [1, 1, 1], [254, 200, 30]],
                       device=cuda)

    def run(sd):
        sigma, rad, radii, cores = level_geometry(sd, units, shape)
        args = (3, radii, cores, units, sigma, rad)
        got = cuda_orient.orient_terms(level, zyx, *args)
        want = cuda_orient.orient_terms_plain(level, zyx, *args)
        torch.cuda.synchronize()
        rel = _rel_dev(got, (want[0].cpu(), want[1].cpu()))
        size = cuda_orient.offset_table(shape, radii, cores, units, sigma,
                                        rad, cuda).numel() * 4
        print(f"orient table sd {sd}: {size} bytes, cache {cache.bytes} "
              f"bytes in {len(cache.entries)} tables, max rel dev {rel:.3e}")
        assert rel <= 1e-5
        return got, size

    _, big = run(60.0)
    assert big > cuda_orient.TABLE_CACHE_BYTES
    assert cache.bytes == 0 and not cache.entries
    first, a = run(50.0)
    assert cache.bytes == a and len(cache.entries) == 1
    _, b = run(48.0)
    assert a + b > cuda_orient.TABLE_CACHE_BYTES
    assert cache.bytes == b and len(cache.entries) == 1
    again, _ = run(50.0)
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    assert cache.bytes == a


@pytest.mark.parametrize("n", [128, 256])
def test_descrip_window_kernel_whole_level(cuda, n):
    """Kernel 1 on rows whose core is a whole n^3 level (the raw-image
    path's windows at octaves 2-5), one of them on a dark region beside a
    bright blob: the z-slab split, the tile-range pass and the fixed-point
    folds against the plain version."""
    rng = np.random.default_rng(12)
    shape = (n,) * 3
    z, y, x = np.meshgrid(*(np.arange(m) for m in shape), indexing="ij")
    bright = np.exp(-((z - 8) ** 2 + (y - 8) ** 2 + (x - 8) ** 2) / 8.0)
    vol = _level(rng, shape) + bright / 1e-4
    level = torch.as_tensor(vol.astype(np.float32)).to(cuda)
    units = (1.0, 1.0, 1.0)
    sigma = float(np.float32(n / 16) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units)
    cores = tuple(window_extent(r, m, False) for r, m in zip(radii, shape))
    assert cores == (n - 2,) * 3
    centers = torch.tensor([[n / 2 + 0.3, n / 2 - 0.4, n / 2 + 0.1],
                            [n - 20.5, n - 30.2, n - 25.7],
                            [5.0, 5.0, 5.0]], device=cuda)
    R = torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                  rng.standard_normal((3, 3, 3))],
                                 np.float32)).to(cuda)
    geom = (radii, cores, units, sigma, rad)
    want = torch.cat([cuda_window.descrip_window_plain(
        level, centers[k:k + 1], R[k:k + 1], 1, *geom) for k in range(2)])
    before = trace.counters().get("launches.descrip_window", 0)
    got = cuda_window.descrip_window(level, centers, R, 2, *geom)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.descrip_window", 0) == before + 1
    assert cuda_window.slab_plan(2, cores[0])[1] > 1
    assert not got[2].any()
    got, want = got[:2].cpu(), want.cpu()
    rel = ((got - want).abs().amax(1) / want.abs().amax(1)).tolist()
    dev = (postprocess(got) - postprocess(want)).abs().max().item()
    print(f"descrip whole {n}^3 level: max |dev| of the raw rows over each "
          f"row's largest bin {rel}, of the descriptors {dev:.3e}")
    assert dev <= 2e-3
    assert max(rel) <= 1e-4


def test_orient_window_kernel_box_walk_past_extent_511(cuda, monkeypatch):
    """F1: kernel 3 on a thin (600, 8, 8) level whose table extent (597)
    passes the 10-bit packing: the rows walk their boxes (no table), in the
    middle, at both ends and past count, against the plain version. Then a
    level that has a table, walked both ways: the box walk (forced by
    BOX_WALK_ENTRIES = 0) agrees with the table walk and the plain
    version."""
    monkeypatch.setattr(cuda_orient, "_statics", cuda_orient._TableCache(
        cuda_orient.TABLE_CACHE_BYTES))
    rng = np.random.default_rng(21)
    for shape, sd, units in (((600, 8, 8), 140.0, (1.0, 1.0, 1.0)),
                             ((300, 40, 36), 25.0, (1.0, 1.3, 0.8))):
        level = torch.as_tensor(_thin_level(rng, shape)).to(cuda)
        sigma, rad, radii, cores = level_geometry(sd, units, shape)
        ext = cuda_orient.table_extents(radii, cores)
        zyx = np.stack([rng.integers(1, n - 1, 7) for n in shape], -1)
        zyx[0] = (1, 1, 1)
        zyx[1] = tuple(n - 2 for n in shape)
        zyx[2] = tuple(n // 2 for n in shape)
        zyx = torch.as_tensor(zyx).to(cuda)
        args = (5, radii, cores, units, sigma, rad)
        want = cuda_orient.orient_terms_plain(level, zyx[:5], *args)
        want = (want[0].cpu(), want[1].cpu())
        assert (want[0].abs().amax(1) > 0).all()
        walks = [False, True] if max(ext) <= cuda_orient.MAX_EXTENT else [True]
        for forced in walks:
            monkeypatch.setattr(cuda_orient, "BOX_WALK_ENTRIES",
                                0 if forced else 1 << 27)
            cuda_orient._statics.clear()
            assert cuda_orient.box_walk(radii, cores) == forced
            before = trace.counters().get("launches.orient_window", 0)
            got = cuda_orient.orient_terms(level, zyx, *args)
            torch.cuda.synchronize()
            assert trace.counters().get(
                "launches.orient_window", 0) == before + 1
            assert not got[0][5:].any() and not got[1][5:].any()
            rel = _rel_dev((got[0][:5], got[1][:5]), want)
            print(f"orient {shape} extents {ext} box walk {forced}: max rel "
                  f"dev {rel:.3e}")
            assert rel <= 1e-5


def test_descrip_window_kernel_core_past_1024(cuda):
    """F1: kernel 1 on a thin (1100, 8, 8) level whose core is 1098 planes
    deep (past the old 1024), split into z-slabs, against the plain
    version."""
    rng = np.random.default_rng(22)
    shape, units = (1100, 8, 8), (1.0, 1.0, 1.0)
    level = torch.as_tensor(_thin_level(rng, shape)).to(cuda)
    sigma = float(np.float32(40.0) * np.float32(DESC_SIG_FCTR))
    rad = float(np.float32(DESC_RAD_FCTR) * np.float32(sigma))
    radii = tuple(int(math.ceil(rad / u)) for u in units)
    cores = tuple(window_extent(r, m, False) for r, m in zip(radii, shape))
    assert cores == (1098, 6, 6)
    centers = torch.tensor([[550.3, 3.6, 4.1], [2.0, 2.0, 2.0],
                            [1090.5, 5.2, 3.3], [700.0, 4.0, 4.0]],
                           device=cuda)
    R = torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                  rng.standard_normal((4, 3, 3))],
                                 np.float32)).to(cuda)
    geom = (radii, cores, units, sigma, rad)
    want = cuda_window.descrip_window_plain(level, centers[:3], R[:3], 3,
                                            *geom).cpu()
    assert (want.abs().amax(1) > 0).all()
    before = trace.counters().get("launches.descrip_window", 0)
    got = cuda_window.descrip_window(level, centers, R, 3, *geom)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.descrip_window", 0) == before + 1
    assert cuda_window.slab_plan(3, cores[0])[1] > 1
    assert not got[3].any()
    got = got[:3].cpu()
    rel = ((got - want).abs().amax(1) / want.abs().amax(1)).tolist()
    dev = (postprocess(got) - postprocess(want)).abs().max().item()
    print(f"descrip core {cores}: max |dev| of the raw rows over each row's "
          f"largest bin {rel}, of the descriptors {dev:.3e}")
    assert dev <= 2e-3
    assert max(rel) <= 1e-4


def test_descrip_window_kernel_four_blocks_an_sm(cuda):
    """The launcher sets the kernel's shared-memory carveout so that 4
    blocks share an SM, not the 5 its registers and shared arrays allow
    (a fifth leaves L1 too small for the window reads)."""
    assert cuda_window.blocks_per_sm() == 4


def test_orient_window_kernel_every_voxel_a_row(cuda):
    """Kernel 3 as the dense rotate variant calls it: every voxel of a
    64^3 level a row of one level at sd = sigma0, in one launch, against
    the plain version on the card."""
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.features.dense import dense_orientations
    rng = np.random.default_rng(23)
    shape = (64, 64, 64)
    level = torch.as_tensor(_level(rng, shape)).to(cuda)
    params = SIFT3DParams(dense_rotate=True)
    before = trace.counters().get("launches.orient_window", 0)
    R_k, A_k, vd_k = dense_orientations(level, (1.0, 1.0, 1.0), params)
    torch.cuda.synchronize()
    assert trace.counters().get("launches.orient_window", 0) == before + 1
    R_p, A_p, vd_p = dense_orientations(
        level, (1.0, 1.0, 1.0), params,
        terms=cuda_orient.orient_terms_levels_plain)
    assert trace.counters().get("launches.orient_window", 0) == before + 1
    assert A_k.shape == (64 ** 3, 6)
    rel = _rel_dev((A_k, vd_k), (A_p.cpu(), vd_p.cpu()))
    print(f"orient every voxel of {shape}: max rel dev {rel:.3e}")
    assert rel <= 1e-5
