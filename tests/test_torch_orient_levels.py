"""The orientation kernel's many-level entry point and its decomposition.

``orient_terms_levels`` takes the rows of every level of a detection in
one call (on the card, one launch). On the CPU it is a loop of
``orient_terms_plain``; these tests hold that loop against the plain
version level by level (exactly) and against the JAX package's Pallas
kernel in interpret mode (within 1e-5 of each row's largest |term|, as
``tests/test_torch_orient.py``). The kernel's own walk, a list of window
offsets inside the sphere per level (``offset_table``) split over
``warps_per_row`` warps, with a core test for rows whose window is
clamped, is mirrored here in numpy: it must visit exactly the voxels of
the plain version's mask, with its weights bit for bit.
``tests/test_torch_kernels.py`` holds the kernel itself on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.ops.pallas_orient import orient_terms_pallas

from sift3d_tpu_torch.features import orientation as tori
from sift3d_tpu_torch.features.windows import window_starts
from sift3d_tpu_torch.ops import cuda_orient
from sift3d_tpu_torch.ops.cuda_orient import (ENTRIES_PER_WARP, MAX_LEVELS,
                                              WARPS, level_groups,
                                              offset_table, orient_terms_levels,
                                              orient_terms_plain, orient_work,
                                              orient_work_levels, table_extents,
                                              unpack, warps_per_row)
from sift3d_tpu_torch.utils import trace

torch.set_num_threads(1)

B = 2
# (shape, units, sd, rows, count): three levels of different shapes, the
# second with anisotropic units, the third clamped to n - 2 on every axis.
LEVELS = [
    ((20, 24, 18), (1.0, 1.0, 1.0), 1.6, 7, 7),
    ((16, 14, 20), (1.0, 1.3, 0.8), 1.4, 6, 4),
    ((8, 8, 8), (2.0, 2.0, 2.0), 3.2, 5, 5),
]


def _level(rng, shape):
    nz, ny, nx = shape
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    vol = np.zeros(shape)
    for _ in range(20):
        c = rng.uniform(0, min(shape), 3)
        s = rng.uniform(1.5, 4.0)
        vol += rng.uniform(-1, 1) * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
            / (2 * s * s))
    return vol.astype(np.float32)


def _thin_level(rng, shape):
    """Blobs centred inside every axis: a level thin in y and x with
    structure all along z."""
    grids = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    vol = np.zeros(shape)
    for _ in range(shape[0] // 8):
        c = [rng.uniform(0, n) for n in shape]
        s = rng.uniform(1.5, 4.0)
        vol += rng.uniform(-1, 1) * np.exp(
            -sum((g - a) ** 2 for g, a in zip(grids, c)) / (2 * s * s))
    return vol.astype(np.float32)


def _rows(rng, shape, n):
    zyx = np.stack([rng.integers(1, s - 1, n) for s in shape], -1)
    zyx[0] = (1, 1, 1)                                   # clamped low
    zyx[1] = tuple(s - 2 for s in shape)                 # clamped high
    vol = rng.integers(0, B, n)
    return np.concatenate([vol[:, None], zyx], 1).astype(np.int32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(8)
    levels, rows, args = [], [], []
    for shape, units, sd, n, count in LEVELS:
        lv = np.stack([_level(rng, shape) for _ in range(B)])
        r = _rows(rng, shape, n)
        sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
        levels.append(lv)
        rows.append(r)
        args.append((torch.as_tensor(lv), n, count, radii, cores, units,
                     sigma, rad))
    return dict(levels=levels, rows=rows, args=args)


def test_levels_equal_plain_level_by_level(case):
    rows = torch.as_tensor(np.concatenate(case["rows"]))
    before = trace.counters().get("launches.orient_window", 0)
    A6, vd = orient_terms_levels(rows, case["args"])
    assert trace.counters().get("launches.orient_window", 0) == before
    assert A6.dtype == torch.float64 and vd.dtype == torch.float32
    assert A6.shape == (rows.shape[0], 6) and vd.shape == (rows.shape[0], 3)
    r0 = 0
    for r, (level, n, count, *geom) in zip(case["rows"], case["args"]):
        r = torch.as_tensor(r)
        want = orient_terms_plain(level, r[:, 1:], count, *geom, vol=r[:, 0])
        assert torch.equal(A6[r0:r0 + n], want[0])
        assert torch.equal(vd[r0:r0 + n], want[1])
        assert not A6[r0 + count:r0 + n].any()
        r0 += n


def test_levels_match_pallas_interpret(case):
    """Each level's rows against the Pallas kernel, one volume at a time."""
    rows = torch.as_tensor(np.concatenate(case["rows"]))
    A6, vd = (t.numpy().astype(np.float64)
              for t in orient_terms_levels(rows, case["args"]))
    r0 = 0
    for lv, r, (_, n, count, radii, cores, units, sigma, rad) in zip(
            case["levels"], case["rows"], case["args"]):
        for b in range(B):
            idx = np.nonzero(r[:count, 0] == b)[0]
            if not idx.size:
                continue
            Ap, vdp = orient_terms_pallas(
                jnp.asarray(lv[b]), jnp.asarray(r[idx, 1:]),
                jnp.int32(idx.size), radii, cores, units, float(sigma),
                float(rad), interpret=True)
            wA, wvd = np.asarray(Ap, np.float64), np.asarray(vdp, np.float64)
            scale = np.maximum(np.abs(wA).max(1), np.abs(wvd).max(1))[:, None]
            assert (scale > 0).all()
            assert (np.abs(A6[r0 + idx] - wA) / scale).max() <= 1e-5
            assert (np.abs(vd[r0 + idx] - wvd) / scale).max() <= 1e-5
        r0 += n


def test_levels_without_rows():
    level = torch.zeros((1, 10, 10, 10))
    geom = ((3, 3, 3), (7, 7, 7), (1.0, 1.0, 1.0), 1.0, 3.0)
    A6, vd = orient_terms_levels(torch.zeros((0, 4), dtype=torch.int32),
                                 [(level, 0, 0, *geom)])
    assert A6.shape == (0, 6) and vd.shape == (0, 3)


@pytest.mark.parametrize("num_levels,empty", [
    (3, ()), (MAX_LEVELS, ()), (MAX_LEVELS + 1, ()),
    (70, (0, 5, 40, 69)), (40, tuple(range(0, 40, 2))), (4, (0, 1, 2, 3)),
])
def test_level_groups_launch_each_level_with_rows_once(num_levels, empty):
    """More levels with rows than one launch's table holds take more
    launches: each level with rows lies in exactly one group, in order,
    and a group holds at most MAX_LEVELS levels."""
    level = torch.zeros((1, 4, 4, 4))
    levels = [(level, 0 if i in empty else i + 1) for i in range(num_levels)]
    groups = level_groups(levels)
    used = [i for i in range(num_levels) if i not in empty]
    assert [j for g in groups for j in g] == used
    assert all(0 < len(g) <= MAX_LEVELS for g in groups)
    assert len(groups) == -(-len(used) // MAX_LEVELS)


def test_levels_args_and_orientations(case):
    """``orientation.levels_args`` builds the case's arguments, and
    ``assign_orientations_levels`` equals the one-level path level by
    level."""
    levels = [(a[0], torch.as_tensor(r), sd, units) for a, r, (_, units, sd,
              _, _) in zip(case["args"], case["rows"], LEVELS)]
    rows, args = tori.levels_args(levels)
    assert torch.equal(rows, torch.as_tensor(np.concatenate(case["rows"])))
    for got, want in zip(args, case["args"]):
        assert got[0] is want[0] and got[1] == want[1] == got[2]
        assert got[3:] == want[3:]
    rows, R, valid = tori.assign_orientations_levels(levels, 0.5)
    r0 = 0
    for level, r, sd, units in levels:
        n = r.shape[0]
        R1, v1 = tori.assign_orientations_level(level, r[:, 1:], sd, units,
                                                0.5, vol=r[:, 0])
        assert torch.equal(R[r0:r0 + n], R1)
        assert torch.equal(valid[r0:r0 + n], v1)
        r0 += n


def test_orient_work_levels_sums_levels(case):
    rows = torch.as_tensor(np.concatenate(case["rows"]))
    want, r0 = [0, 0, 0, 0], 0
    for level, n, count, *geom in case["args"]:
        r = rows[r0:r0 + n]
        w = orient_work(level, r[:, 1:], count, *geom, vol=r[:, 0])
        want = [a + b for a, b in zip(want, w)]
        r0 += n
    assert list(orient_work_levels(rows, case["args"])) == want
    assert want[3] > 0


def test_orient_work_levels_reads_a_shared_tensor_once(case):
    """Levels on one tensor (the raw-image path's buckets on one smoothed
    image) read the union of their windows once; levels on copies, once
    each."""
    level, n, count, *geom = case["args"][0]
    r = torch.as_tensor(case["rows"][0])
    one = orient_work(level, r[:, 1:], count, *geom, vol=r[:, 0])
    rows = torch.cat([r, r])
    shared = orient_work_levels(rows, [case["args"][0]] * 2)
    copies = orient_work_levels(rows, [case["args"][0],
                                       (level.clone(), n, count, *geom)])
    assert list(copies) == [2 * x for x in one]
    row_bytes = 16 * min(count, n) + n * (6 * 8 + 3 * 4)
    assert shared[0] == one[0] + row_bytes < copies[0]
    assert list(shared[1:]) == [2 * x for x in one[1:]]


@pytest.mark.parametrize("entries", [1, 31, 512, 513, 2048, 2572, 8181,
                                     40000])
def test_warps_per_row_covers_each_entry_once(entries):
    P = warps_per_row(entries)
    assert P in (1, 2, 4, 8) and WARPS % P == 0
    assert P == WARPS or -(-entries // P) <= ENTRIES_PER_WARP
    assert P == 1 or -(-entries // (P // 2)) > ENTRIES_PER_WARP
    hits = np.zeros(entries, int)
    for piece in range(P):          # warp `piece` takes chunks piece, +P..
        for lane in range(32):
            hits[np.arange(piece * 32 + lane, entries, 32 * P)] += 1
    assert (hits == 1).all()


def _walk(tab, shape, zyx, radii, cores):
    """The kernel's walk of one row: the (z, y, x) voxels and weights of
    the table entries it counts, and whether it skipped the core test."""
    off, packed = tab[:, 0].long(), tab[:, 1].long()
    w = tab[:, 2:].contiguous().view(torch.float64).reshape(-1)
    d = torch.stack(unpack(packed), 1)
    starts = window_starts(shape, torch.as_tensor(zyx)[None], radii, cores)[0]
    lo = starts - torch.as_tensor(zyx)
    hi = lo + torch.as_tensor(cores) - 1
    ext = torch.as_tensor(table_extents(radii, cores))
    full = bool((lo <= -ext).all() and (hi >= ext).all())
    ok = ((d >= lo) & (d <= hi)).all(1)
    assert not full or ok.all(), "a full row must need no core test"
    nz, ny, nx = shape
    v = d[ok] + torch.as_tensor(zyx)
    assert torch.equal((d[ok, 0] * ny + d[ok, 1]) * nx + d[ok, 2], off[ok])
    return v, w[ok], full


@pytest.mark.parametrize("units,sd,shape", [
    ((1.0, 1.0, 1.0), 1.6, (30, 32, 28)),
    ((1.0, 1.3, 0.8), 1.6, (30, 32, 28)),
    ((0.7, 1.0, 2.1), 2.0, (20, 26, 36)),
    ((1.0, 1.0, 1.0), 3.0, (8, 10, 12)),       # cores clamped to n - 2
    ((1.0, 1.3, 0.8), 3.0, (14, 40, 9)),       # some axes clamped
    ((0.1, 15.0, 15.0), 10 / 3, (6, 6, 320)),  # a 3 x 3 x 301 box
])
def test_offset_walk_visits_exactly_the_mask(units, sd, shape):
    """Every voxel the plain version counts is visited once, with its
    weight bit for bit, and no other voxel: at rows in the middle, at the
    edges and at random positions."""
    rng = np.random.default_rng(3)
    sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
    tab = offset_table(shape, radii, cores, units, sigma, rad, "cpu")
    assert tab.dtype == torch.int32 and tab.shape[1] == 4
    g = cuda_orient._constants(units, sigma, rad)
    zyx = np.stack([rng.integers(1, s - 1, 12) for s in shape], -1)
    zyx[0] = (1, 1, 1)
    zyx[1] = tuple(s - 2 for s in shape)
    zyx[2] = tuple(s // 2 for s in shape)
    zyx[3] = (1, shape[1] // 2, shape[2] - 2)
    fulls = 0
    for c in zyx:
        v, w, full = _walk(tab, shape, c, radii, cores)
        fulls += full
        starts, sq, in_box = cuda_orient._frame(
            shape, torch.as_tensor(c)[None], radii, cores, g)
        mask = (in_box & (sq <= g["rad2"]))[0]
        want_w = cuda_orient._weight(sq, g)[0][mask].to(torch.float64)
        idx = torch.nonzero(mask) + starts[0]
        assert torch.equal(v, idx), "walk and mask differ"
        assert torch.equal(w, want_w)
    if min(cores[a] - 1 - radii[a] for a in range(3)) >= 0:
        assert fulls > 0, "no row took the walk without core tests"


def test_offset_walk_sums_equal_plain():
    """The walk's sums (float64, numpy) equal the plain version's within
    1e-12 of each row's largest |term|."""
    rng = np.random.default_rng(5)
    shape, units, sd = (22, 18, 20), (1.0, 1.3, 0.8), 1.6
    level = torch.as_tensor(_level(rng, shape))
    sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
    tab = offset_table(shape, radii, cores, units, sigma, rad, "cpu")
    zyx = np.stack([rng.integers(1, s - 1, 6) for s in shape], -1)
    A6, vd = orient_terms_plain(level, torch.as_tensor(zyx), 6, radii, cores,
                                units, sigma, rad)
    lv = level.numpy()
    inv = [np.float32(1.0) / np.float32(u) for u in units]
    for k, c in enumerate(zyx):
        v, w, _ = _walk(tab, shape, c, radii, cores)
        z, y, x = v.numpy().T
        f = np.float32
        gx = (f(0.5) * (lv[z, y, x + 1] - lv[z, y, x - 1])) * inv[0]
        gy = (f(0.5) * (lv[z, y + 1, x] - lv[z, y - 1, x])) * inv[1]
        gz = (f(0.5) * (lv[z + 1, y, x] - lv[z - 1, y, x])) * inv[2]
        G = [t.astype(np.float64) for t in (gx, gy, gz)]
        w = w.numpy()
        got = np.array([np.sum(G[i] * G[j] * w) for i, j in
                        ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))] +
                       [np.sum(G[i] * w) for i in range(3)])
        want = np.concatenate([A6[k].numpy(), vd[k].numpy()])
        scale = np.abs(want).max()
        assert np.abs(got[:6] - want[:6]).max() <= 1e-12 * scale
        assert np.abs(got[6:] - want[6:]).max() <= 1e-5 * scale



def test_pack_round_trips_every_offset_up_to_max_extent():
    e = cuda_orient.MAX_EXTENT
    assert e > 127
    d = torch.tensor([-e, -e + 1, -128, -1, 0, 1, 127, 128, 300, e])
    dz, dy, dx = torch.meshgrid(d, d, d, indexing="ij")
    packed = cuda_orient._pack(dz, dy, dx)
    assert packed.min() >= 0 and packed.max() < 2 ** 31
    for got, want in zip(unpack(packed.to(torch.int32)), (dz, dy, dx)):
        assert torch.equal(got.long(), want)


def test_offset_table_past_127():
    """A table whose x extent (150) passes a byte: 3 x 3 x 301 offsets,
    packed and level offsets as the kernel reads them."""
    units, sd, shape = (0.1, 15.0, 15.0), 10 / 3, (6, 6, 320)
    sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
    ext = table_extents(radii, cores)
    assert ext == (1, 1, 150)
    tab = offset_table(shape, radii, cores, units, sigma, rad, "cpu")
    d = torch.stack(unpack(tab[:, 1]), 1).long()
    assert d[:, 2].min() == -150 and d[:, 2].max() == 150
    assert torch.equal((d[:, 0] * 6 + d[:, 1]) * 320 + d[:, 2],
                       tab[:, 0].long())
    g = cuda_orient._constants(units, sigma, rad)
    sq = cuda_orient._sq(d[:, 0], d[:, 1], d[:, 2], g)
    assert (sq <= g["rad2"]).all()
    box = torch.stack(torch.meshgrid(*(torch.arange(-e, e + 1) for e in ext),
                                     indexing="ij"), -1).reshape(-1, 3)
    inside = cuda_orient._sq(box[:, 0], box[:, 1], box[:, 2], g) <= g["rad2"]
    assert tab.shape[0] == int(inside.sum())


@pytest.mark.parametrize("radii,cores,shape", [
    ((600, 3, 3), (600, 5, 5), (610, 7, 7)),            # extent past 511
    ((500, 500, 500), (990, 990, 4990), (1000, 1000, 5000)),  # past int32
])
def test_offset_table_refuses_what_the_kernel_cannot_take(radii, cores,
                                                          shape):
    with pytest.raises(ValueError, match="orient_window"):
        offset_table(shape, radii, cores, (1.0, 1.0, 1.0), 100.0, 300.0,
                     "cpu")


def test_table_cache_evicts_least_recent_by_bytes():
    cache = cuda_orient._TableCache(limit=3 * 64)
    tab = [torch.zeros((4, 4), dtype=torch.int32) for _ in range(5)]  # 64 B
    for k in range(3):
        cache.put(k, (None, 1, tab[k]))
    assert cache.get(0) is not None           # 0 is now the most recent
    cache.put(3, (None, 1, tab[3]))
    assert cache.get(1) is None and cache.bytes == 3 * 64
    assert [k for k in cache.entries] == [2, 0, 3]
    cache.put(4, (None, 1, torch.zeros((8, 8), dtype=torch.int32)))  # 256 B
    assert cache.get(4) is None and cache.bytes == 3 * 64


# F1: the raw-image paths on volumes past 512 voxels a side. Levels whose
# table extents pass MAX_EXTENT (or whose table box passes
# BOX_WALK_ENTRIES) have no table; their rows walk their core boxes.
def _raw_geometry(shape):
    """{(o, s): (orientation table extents, box_walk, descriptor cores)}
    of the raw-image path's keypoint levels on a ``shape`` volume."""
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.features import descriptor as tdesc
    from sift3d_tpu_torch.features.detect import kp_levels
    plan = pyr.plan_pyramid(shape[::-1], (1.0, 1.0, 1.0), SIFT3DParams())
    out = {}
    for o, s in kp_levels(plan):
        sd = plan.gpyr_level(o, s).scale
        _, _, radii, cores = tori.level_geometry(sd, (1.0, 1.0, 1.0), shape)
        out[(o, s)] = (table_extents(radii, cores),
                       cuda_orient.box_walk(radii, cores),
                       tdesc.level_geometry(sd, (1.0, 1.0, 1.0), shape)[3])
    return out


def test_f1_geometry_past_the_old_limits():
    """At 600 x 512 x 512 the orientation tables of levels (6, 1) and
    (6, 2) reach extents (581, 509, 509) and (597, 509, 509), past the
    10-bit packing; at 1100 x 512 x 512 the descriptor core reaches 1098
    on z, past kernel 1's old 1024. Both are taken: the orientation levels
    as box walks (no table, 8 warps a row), the cores by the launcher."""
    g = _raw_geometry((600, 512, 512))
    assert g[(6, 1)][0] == (581, 509, 509)
    assert g[(6, 2)][0] == (597, 509, 509)
    assert all(walk for ext, walk, _ in g.values()
               if max(ext) > cuda_orient.MAX_EXTENT)
    sigma, rad, radii, cores = tori.level_geometry(
        160.0, (1.0, 1.0, 1.0), (600, 512, 512))
    assert table_extents(radii, cores) == (597, 509, 509)
    lv, per_block, tab = cuda_orient._level_static(
        (600, 512, 512), radii, cores, (1.0, 1.0, 1.0), sigma, rad, "cpu")
    assert tab.numel() == 0 and lv.entries == 0 and not lv.table
    assert per_block == 1 and lv.log2_warps == 3
    with pytest.raises(ValueError, match="orient_window"):
        offset_table((600, 512, 512), radii, cores, (1.0, 1.0, 1.0), sigma,
                     rad, "cpu")
    g = _raw_geometry((1100, 512, 512))
    assert max(c[0] for _, _, c in g.values()) == 1098
    assert g[(4, 2)][2] == (1098, 510, 510)
    # At 512^3 nothing passes MAX_EXTENT.
    g = _raw_geometry((512, 512, 512))
    assert max(max(e) for e, _, _ in g.values()) == 509


@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 512, 512)])
def test_raw_levels_walk_boxes_from_octave_4(shape):
    """The raw-image path's levels from octave 4 on (table boxes of 12.6 M
    offsets and more) pass BOX_WALK_ENTRIES and walk their boxes, where the
    table walk was slower; octave 3's largest (6.3 M offsets, where the two
    walks took the same time) and every smaller one keep their tables."""
    g = _raw_geometry(shape)
    for (o, s), (ext, walk, _) in g.items():
        box = math.prod(2 * e + 1 for e in ext)
        assert walk == (o >= 4), ((o, s), ext)
        assert walk == (box > cuda_orient.BOX_WALK_ENTRIES)
    assert max(math.prod(2 * e + 1 for e in ext)
               for (o, _), (ext, _, _) in g.items() if o < 4) == 185 ** 3


def _walk_box(shape, zyx, radii, cores, g, warps=8):
    """The kernel's box walk of one row (``walk_box`` in
    ``csrc/orient_window.cu``), lane by lane with its mixed-radix steps:
    the (z, y, x) voxels it counts, each with the kernel's fp32 weight."""
    f = np.float32
    starts = window_starts(shape, torch.as_tensor(zyx)[None], radii,
                           cores)[0].numpy()
    lo_core = starts - np.asarray(zyx)
    hi_core = lo_core + np.asarray(cores) - 1
    lo = np.maximum(lo_core, -np.asarray(radii))
    n = np.minimum(hi_core, np.asarray(radii)) - lo + 1
    step = 32 * warps
    vox, w = [], []
    sx, sy, sz = step % n[2], step // n[2] % n[1], step // n[2] // n[1]
    for e in range(step):
        x, y, z = e % n[2], e // n[2] % n[1], e // n[2] // n[1]
        while z < n[0]:
            d = lo + (z, y, x)
            v = [f(f(d[a]) * f(g[k])) for a, k in ((2, "ux"), (1, "uy"),
                                                   (0, "uz"))]
            sq = f(f(f(v[0] * v[0]) + f(v[1] * v[1])) + f(v[2] * v[2]))
            if sq <= f(g["rad2"]):
                vox.append(d + zyx)
                w.append(np.exp(f(f(f(-0.5) * sq) * f(g["w_scale"]))))
            x += sx
            carry = x >= n[2]
            x -= n[2] * carry
            y += sy + carry
            if y >= n[1]:
                y -= n[1]
                z += 1
            z += sz
    return np.array(vox).reshape(-1, 3), np.array(w, np.float64)


@pytest.mark.parametrize("units,sd,shape", [
    ((1.0, 1.0, 1.0), 140.0, (600, 8, 8)),      # a thin level, extent 597
    ((1.0, 1.3, 0.8), 1.6, (30, 32, 28)),
    ((1.0, 1.0, 1.0), 3.0, (8, 10, 12)),        # cores clamped to n - 2
])
def test_box_walk_visits_exactly_the_mask(units, sd, shape):
    """Every voxel the plain version counts is visited once, with the
    plain version's weight to fp32 rounding, and no other voxel: rows in
    the middle, at the edges and at random positions. The weights differ from the CPU's
    plain version by a few fp32 ulps: it divides by sigma^2, where torch
    on the card and the kernel multiply by its fp32 reciprocal."""
    rng = np.random.default_rng(4)
    sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
    g = cuda_orient._constants(units, sigma, rad)
    zyx = np.stack([rng.integers(1, s - 1, 5) for s in shape], -1)
    zyx[0] = (1, 1, 1)
    zyx[1] = tuple(s - 2 for s in shape)
    zyx[2] = tuple(s // 2 for s in shape)
    for c in zyx:
        vox, w = _walk_box(shape, c, radii, cores, g)
        starts, sq, in_box = cuda_orient._frame(
            shape, torch.as_tensor(c)[None], radii, cores, g)
        mask = (in_box & (sq <= g["rad2"]))[0]
        want_w = cuda_orient._weight(sq, g)[0][mask].double().numpy()
        want = (torch.nonzero(mask) + starts[0]).numpy()
        order = np.lexsort(vox.T[::-1])
        np.testing.assert_array_equal(vox[order], want)
        np.testing.assert_allclose(w[order], want_w, rtol=1e-6, atol=0)


def test_box_walk_sums_equal_plain_on_a_thin_level():
    """The box walk's float64 sums on a (600, 8, 8) level whose table
    extent (597) passes the packing equal the plain version's within 1e-6
    of each row's largest |term| (the weights agree to fp32 rounding)."""
    rng = np.random.default_rng(6)
    shape, units, sd = (600, 8, 8), (1.0, 1.0, 1.0), 140.0
    level = torch.as_tensor(_thin_level(rng, shape))
    sigma, rad, radii, cores = tori.level_geometry(sd, units, shape)
    assert table_extents(radii, cores)[0] > cuda_orient.MAX_EXTENT
    assert cuda_orient.box_walk(radii, cores)
    g = cuda_orient._constants(units, sigma, rad)
    zyx = np.array([[300, 4, 4], [1, 1, 1], [598, 6, 2], [37, 3, 5]])
    A6, vd = orient_terms_plain(level, torch.as_tensor(zyx), 4, radii, cores,
                                units, sigma, rad)
    lv = level.numpy()
    inv = [np.float32(1.0) / np.float32(u) for u in units]
    f = np.float32
    for k, c in enumerate(zyx):
        vox, w = _walk_box(shape, c, radii, cores, g)
        z, y, x = vox.T
        gx = (f(0.5) * (lv[z, y, x + 1] - lv[z, y, x - 1])) * inv[0]
        gy = (f(0.5) * (lv[z, y + 1, x] - lv[z, y - 1, x])) * inv[1]
        gz = (f(0.5) * (lv[z + 1, y, x] - lv[z - 1, y, x])) * inv[2]
        G = [t.astype(np.float64) for t in (gx, gy, gz)]
        got = np.array([np.sum(G[i] * G[j] * w) for i, j in
                        ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))] +
                       [np.sum(G[i] * w) for i in range(3)])
        want = np.concatenate([A6[k].numpy(), vd[k].numpy()])
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
