"""Port parity: the extrema glue (``features/extrema.extrema_levels``)
that the kernels of ``ops/cuda_extrema.py`` and their plain version share,
on the CPU against ``sift3d_tpu``'s ``level_extrema``.

Every keypoint level of a DoG pyramid goes through one
``extrema_levels`` call: the rows, counts and totals of each level and
volume equal JAX's exactly, the counts come to the host in one read
(``sync.extrema``), each level's rows are a slice of one buffer, and
``total > count`` flags the volumes that lost rows at a capacity. The
kernels' work counts (``cuda_extrema.scan_work``) are held to a count from
JAX's rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.features.extrema import level_extrema as jlevel_extrema

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features import detect as tdetect
from sift3d_tpu_torch.features import extrema
from sift3d_tpu_torch.ops import cuda_extrema
from sift3d_tpu_torch.utils import trace

from tests.conftest import make_blob_volume

torch.set_num_threads(1)

# name: ((nz, ny, nx), volumes, seeds, SIFT3DParams fields)
CASES = {
    "iso32.one": ((32, 32, 32), 1, (7,), {}),
    "aniso.two": ((32, 40, 48), 2, (5, 6), {}),
    "iso48.capped": ((48, 48, 48), 2, (8, 9),
                     dict(max_kp_per_level=6, max_kp_per_octave=(4, 2))),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    shape, B, seeds, fields = CASES[request.param]
    params = SIFT3DParams(**fields)
    vols = torch.as_tensor(np.stack([make_blob_volume(shape, seed=s)
                                     for s in seeds]))
    plan = tpyr.plan_pyramid(shape[::-1], (1.0, 1.0, 1.0), params)
    dog = tpyr.build_dog(tpyr.build_gpyr(tpyr.im_scale(vols), plan), plan)
    keys = tdetect.kp_levels(plan)
    levels = tdetect.extrema_args(dog, plan, params)
    before = trace.counters()
    got = extrema.extrema_levels(levels, params.peak_thresh)
    after = trace.counters()
    counted = {k: v - before.get(k, 0) for k, v in after.items()
               if v != before.get(k, 0)}
    want = []
    for prev, cur, nxt, cap in levels:
        per_vol = []
        for b in range(B):
            zyx, count, total = jlevel_extrema(
                *(jnp.asarray(t[b].numpy()) for t in (prev, cur, nxt)),
                params.peak_thresh, cap)
            per_vol.append((np.asarray(zyx)[:int(count)], int(count),
                            int(total)))
        want.append(per_vol)
    return dict(B=B, keys=keys, levels=levels, got=got, want=want,
                counted=counted, params=params, dog=dog, plan=plan,
                launches=counted.get("launches.extrema_scan", 0))


def _rows_counts_totals_equal_jax(r):
    n = 0
    for (rows, count, total), per_vol in zip(r["got"], r["want"]):
        assert rows.dtype == torch.int32 and rows.shape[1] == 4
        for b, (zyx, c, t) in enumerate(per_vol):
            np.testing.assert_array_equal(rows[rows[:, 0] == b, 1:].numpy(),
                                          zyx)
            assert (int(count[b]), int(total[b])) == (c, t)
        n += rows.shape[0]
    assert n > 5, "too few extrema to be a real test"


def _one_read_a_call(r):
    c = r["counted"]
    assert c["sync.extrema"] == 1
    assert c["extrema.levels"] == len(r["keys"])
    assert c["extrema.rows"] == sum(g[0].shape[0] for g in r["got"])
    # The plain version on the CPU: no kernel level, no launch.
    assert "extrema.kernel_levels" not in c and r["launches"] == 0


def _levels_slice_one_buffer(r):
    rows = [g[0] for g in r["got"]]
    base = rows[0].untyped_storage().data_ptr()
    offset = 0
    for x in rows:
        assert x.untyped_storage().data_ptr() == base
        assert x.storage_offset() == offset
        offset += x.numel()
    # Within a level, the volumes in order.
    for x in rows:
        assert torch.equal(x[:, 0], x[:, 0].sort().values)


def _overflow_flags_equal_jax(r):
    flags = tdetect.overflow_flags(dict(zip(r["keys"], r["got"])))
    want = np.array([any(t > c for (_, c, t) in (per_vol[b]
                                                 for per_vol in r["want"]))
                     for b in range(r["B"])])
    np.testing.assert_array_equal(flags.numpy(), want)
    capped = r["params"].max_kp_per_octave is not None
    assert want.all() == capped


def _detect_extrema_levels_same(r):
    ext = tdetect.detect_extrema_levels(r["dog"], r["plan"], r["params"])
    assert list(ext) == r["keys"]
    for key, (rows, count, total) in zip(r["keys"], r["got"]):
        assert torch.equal(ext[key][0], rows)
        assert torch.equal(ext[key][1], count)
        assert torch.equal(ext[key][2], total)


def _single_volume_form(r):
    """Three-dimensional levels give the one-volume form of volume 0's
    batch rows, with the ints of its count and total."""
    single = extrema.extrema_levels(
        [(p[0], c[0], n[0], cap) for p, c, n, cap in r["levels"]],
        r["params"].peak_thresh)
    for (zyx, count, total), (rows, bc, bt) in zip(single, r["got"]):
        assert torch.equal(zyx, rows[rows[:, 0] == 0, 1:])
        assert (count, total) == (int(bc[0]), int(bt[0]))
        assert isinstance(count, int) and isinstance(total, int)


def _sectors(mask):
    return np.unique(np.flatnonzero(mask) // 8).size


def _scan_work_counts(r):
    """``cuda_extrema.scan_work``'s counts against a count from JAX's rows
    and numpy: the emit pass walks the blocks that hold a kept row (a
    block with hits whose first rank is below the capacity)."""
    least = design = ops = passing = found = 0
    for (prev, cur, nxt, cap), per_vol in zip(r["levels"], r["want"]):
        c = cur.numpy()
        B, nz, ny, nx = c.shape
        t = (np.float32(r["params"].peak_thresh) *
             np.abs(c).max(axis=(1, 2, 3)))[:, None, None, None]
        ok = np.zeros(c.shape, bool)
        inner = c[:, 1:-1, 1:-1, 1:-1]
        ok[:, 1:-1, 1:-1, 1:-1] = (inner > t) | (inner < -t)
        rpb = cuda_extrema.rows_per_block(nx)
        walk = np.zeros(c.shape, bool)
        n = 0
        for b, (zyx, _, _) in enumerate(per_vol):
            row = (zyx[:, 0] - 1) * (ny - 2) + (zyx[:, 1] - 1)
            for k in np.unique(row // rpb):
                for q in range(k * rpb, min((k + 1) * rpb,
                                            (nz - 2) * (ny - 2))):
                    z, y = divmod(q, ny - 2)
                    walk[b, z + 1, y + 1, 1:-1] = True
            n += zyx.shape[0]
        s_ok = _sectors(ok)
        least += 4 * c.size + 64 * s_ok + 16 * n
        design += (8 * c.size + 64 * s_ok + 32 * _sectors(walk) +
                   64 * _sectors(ok & walk) + 16 * n)
        ops += c.size + 2 * inner.size + 16 * int(ok.sum())
        passing += int(ok.sum())
        found += n
    got = cuda_extrema.scan_work(r["levels"], r["params"].peak_thresh)
    assert got == (least, design, ops, passing, found)
    assert least < design


CHECKS = {f.__name__.lstrip("_"): f for f in (
    _rows_counts_totals_equal_jax, _one_read_a_call,
    _levels_slice_one_buffer, _overflow_flags_equal_jax,
    _detect_extrema_levels_same, _single_volume_form, _scan_work_counts)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_extrema_levels(run, check):
    CHECKS[check](run)


@pytest.mark.parametrize("nx,rows", [(3, 8 * 512), (12, 8 * 51),
                                     (46, 8 * 12), (182, 8 * 3),
                                     (600, 8), (5000, 8)])
def test_extrema_block_rows(nx, rows):
    """A count / emit block holds whole interior rows, a multiple of the
    warps, near BLOCK_VOXELS voxels (at least one row a warp)."""
    assert cuda_extrema.rows_per_block(nx) == rows
    assert rows % cuda_extrema.WARPS == 0


def test_extrema_level_table_layout():
    """The ctypes mirror of the kernels' level struct has the C layout the
    source asserts (80 bytes, the 64-bit block index last)."""
    import ctypes
    L = cuda_extrema._Level
    assert ctypes.sizeof(L) == 80
    assert L.gblock0.offset == 72 and L.capacity.offset == 64


@pytest.mark.parametrize("n_levels", [1, 32, 33, 70])
def test_extrema_launch_groups(n_levels):
    """Levels go to the kernels in launches of at most MAX_LEVELS, each
    level's first count / emit and max-pass blocks counted from its
    launch's start, in level order."""
    entries = [(cuda_extrema._Level(gblock0=i), 1 + i % 3, 2 + i % 5)
               for i in range(n_levels)]
    groups = cuda_extrema._groups(entries)
    assert [g[1] for g in groups] == [
        min(cuda_extrema.MAX_LEVELS, n_levels - j)
        for j in range(0, n_levels, cuda_extrema.MAX_LEVELS)]
    i = 0
    for table, n, blocks, max_blocks in groups:
        b = m = 0
        for e in table:
            assert (e.gblock0, e.block0, e.max_block0) == (i, b, m)
            b += 1 + i % 3
            m += 2 + i % 5
            i += 1
        assert (blocks, max_blocks) == (b, m)
    assert i == n_levels


def test_extrema_levels_empty_and_no_interior():
    """No levels give no result; a level with no interior voxel gives no
    rows and zero counts, in one read."""
    assert extrema.extrema_levels([], 0.1) == []
    z = torch.zeros((2, 2, 9, 9))
    before = trace.counters().get("sync.extrema", 0)
    (rows, count, total), = extrema.extrema_levels([(z, z, z, 5)], 0.1)
    assert trace.counters()["sync.extrema"] == before + 1
    assert rows.shape == (0, 4) and not count.any() and not total.any()
