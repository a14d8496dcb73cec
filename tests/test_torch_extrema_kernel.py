"""The extrema kernels (``csrc/extrema_scan.cu``, ``ops/cuda_extrema.py``)
against their plain version (``cuda_extrema.scan_plain``), bit for
bit: rows, counts and totals.

These need the card (the kernels are built with nvcc for sm_90a and have
no CPU mode) and skip elsewhere; on a machine with the card run
``python -m pytest --noconftest tests/test_torch_extrema_kernel.py -q``
(this file needs no JAX, which ``tests/conftest.py`` imports). The plain
version runs on the same card tensors, so both see the same inputs.
"""

import pytest
import torch

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features import detect as tdetect
from sift3d_tpu_torch.features import extrema
from sift3d_tpu_torch.ops import cuda_extrema
from sift3d_tpu_torch.utils import trace

MNI152 = (182, 218, 182)      # (nz, ny, nx) of the benchmark's grid


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _plain(levels, thresh):
    """The plain version on the same tensors: (rows, count, total) a
    level."""
    count, total, emit = cuda_extrema.scan_plain(levels, thresh)
    rows = emit(int(count.sum()))
    sizes = count.sum(1).tolist()
    return list(zip(torch.split(rows, sizes), count, total))


def _check(levels, thresh):
    """The kernels' rows, counts and totals equal the plain version's;
    returns the kernels' (rows, count, total) a level."""
    before = trace.counters().get("extrema.kernel_levels", 0)
    got = extrema.extrema_levels(levels, thresh)
    assert trace.counters()["extrema.kernel_levels"] == before + len(levels)
    want = _plain(levels, thresh)
    assert len(got) == len(want)
    for (gr, gc, gt), (wr, wc, wt) in zip(got, want):
        assert gr.dtype == torch.int32 and gr.device.type == "cuda"
        assert torch.equal(gc, wc) and torch.equal(gt, wt), (gc, wc, gt, wt)
        assert torch.equal(gr, wr)
    return got


def _noise(shape, seed, B=2, smooth=True):
    """(B, nz, ny, nx) levels: noise, box-smoothed along x (runs of equal
    sign, fewer extrema) where ``smooth``."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((B,) + tuple(shape), generator=g)
    if smooth:
        v = (v + v.roll(1, -1) + v.roll(-1, -1)) / 3
    return v


def _triple(shape, seed, B=2, smooth=True):
    return [_noise(shape, seed + i, B, smooth) for i in range(3)]


def test_extrema_kernel_mni152_octaves(cuda):
    """Every keypoint level of a real DoG pyramid at the benchmark's grid,
    B = 2 (smoothed noise: extrema in every octave), through
    ``detect_extrema_levels``: one kernel launch a pass, equal to the plain
    version."""
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(MNI152[::-1], (1.0, 1.0, 1.0), params)
    vols = torch.randn((2,) + MNI152,
                       generator=torch.Generator().manual_seed(3)).to(cuda)
    dog = tpyr.build_dog(tpyr.build_gpyr(tpyr.im_scale(vols), plan), plan)
    keys = tdetect.kp_levels(plan)
    levels = [(dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)],
               tdetect.level_cap(plan, o, params)) for o, s in keys]
    before = trace.counters().get("launches.extrema_scan", 0)
    got = _check(levels, params.peak_thresh)
    assert trace.counters().get("launches.extrema_scan", 0) == before + 3
    assert all(int(c.sum()) > 0 for _, c, _ in got)
    ext = tdetect.detect_extrema_levels(dog, plan, params)
    for key, (r, c, t) in zip(keys, got):
        assert torch.equal(ext[key][0], r) and torch.equal(ext[key][2], t)
    print("mni152 extrema rows a level:",
          [int(c.sum()) for _, c, _ in got])


@pytest.mark.parametrize("shape", [(3, 3, 3), (3, 4, 5), (12, 14, 12),
                                   (2, 9, 9), (9, 9, 2)])
def test_extrema_kernel_small_levels(cuda, shape):
    """A one-voxel interior, the MNI152 octave-4 size and levels with no
    interior at all; rough noise so that the small ones hold extrema."""
    lv = [t.to(cuda) for t in _triple(shape, 11, B=3, smooth=False)]
    if shape == (3, 3, 3):
        lv[1][:, 1, 1, 1] = 10.0          # the one interior voxel a maximum
        lv[1][1, 1, 1, 1] = -10.0         # and in volume 1 a minimum
    got = _check([(*lv, 8192)], 0.1)
    n = int(got[0][1].sum())
    assert n == 0 if min(shape) < 3 else n > 0


@pytest.mark.parametrize("cap", [1, 2, 37, 300, 5000])
def test_extrema_kernel_capacity_truncates_in_scan_order(cuda, cap):
    """Rough noise at 64^3 holds thousands of extrema a volume, hundreds a
    block: capacities below the total (1, inside the first block, across
    blocks) keep the first rows in scan order and report the total."""
    lv = [t.to(cuda) for t in _triple((64, 64, 64), 21, smooth=False)]
    (rows, count, total), = _check([(*lv, cap)], 0.05)
    assert (total > cap).all() and (count == cap).all()
    assert rows.shape[0] == 2 * cap


def test_extrema_kernel_single_volume_form(cuda):
    """Three-dimensional levels give ``level_extrema``'s one-volume form
    (zyx, count, total as ints), equal to the plain version's."""
    p, c, n = (t[0].to(cuda) for t in _triple((40, 36, 44), 31))
    zyx, count, total = extrema.level_extrema(p, c, n, 0.1, 50)
    (rows, wc, wt), = _plain([(p[None], c[None], n[None], 50)], 0.1)
    assert torch.equal(zyx, rows[:, 1:])
    assert (count, total) == (int(wc[0]), int(wt[0])) and total > count


def test_extrema_kernel_plateaus(cuda):
    """Values on a few steps: equal neighbours everywhere, which are never
    strict extrema."""
    lv = [(t * 2).round().to(cuda) for t in _triple((30, 34, 38), 41)]
    (rows, count, _), = _check([(*lv, 8192)], 0.1)
    assert int(count.sum()) > 0
    b, z, y, x = rows.long().T
    cur = lv[1]
    for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)):
        assert (cur[b, z, y, x] != cur[b, z + dz, y + dy, x + dx]).all()


def test_extrema_kernel_zero_volume(cuda):
    """A volume of zeros (max |DoG| 0, threshold 0) beside one with
    extrema: none in the first, the second's as the plain version's."""
    lv = [t.to(cuda) for t in _triple((24, 26, 28), 51)]
    for t in lv:
        t[0] = 0.0
    (_, count, total), = _check([(*lv, 8192)], 0.1)
    assert int(total[0]) == 0 and int(count[1]) > 0


def test_extrema_kernel_more_levels_than_a_launch(cuda):
    """40 levels of several shapes and capacities (one with no interior)
    take two launches a pass, one per group of MAX_LEVELS."""
    levels = []
    for i in range(40):
        shape = (2, 8, 8) if i == 7 else (10 + i % 4, 12 - i % 3, 9 + i % 5)
        lv = [t.to(cuda) for t in _triple(shape, 100 + i, B=2,
                                          smooth=bool(i % 2))]
        levels.append((*lv, 1 + i * 7))
    before = trace.counters().get("launches.extrema_scan", 0)
    got = _check(levels, 0.1)
    assert trace.counters().get("launches.extrema_scan", 0) == before + 6
    assert sum(int(c.sum()) for _, c, _ in got) > 0


def test_extrema_kernel_noncontiguous_levels(cuda):
    """Levels that are views of larger tensors (the wrapper makes
    contiguous copies and holds them until the emit pass is queued)."""
    big = [t.to(cuda) for t in _triple((30, 32, 34), 61, B=3)]
    lv = [t.transpose(2, 3)[:, 1:27] for t in big]
    assert not any(t.is_contiguous() for t in lv)
    _check([(*lv, 8192), (*(t[:, :, 2:30, 1:31] for t in big), 90)], 0.1)


def test_extrema_kernel_repeats_bits(cuda):
    """Two calls on the same levels give the same rows (the totals are
    integer atomics and the maxima atomicMax: no order dependence)."""
    lv = [t.to(cuda) for t in _triple((48, 50, 52), 71, smooth=False)]
    a = extrema.extrema_levels([(*lv, 777)], 0.05)
    b = extrema.extrema_levels([(*lv, 777)], 0.05)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
