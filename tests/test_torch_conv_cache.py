"""The blur operators kept on the device (``ops/conv.device_operators``).

``conv_sep`` copies each axis's matrix (or framed tile set) to the
volume's device once per (matrix, device, dtype), counted as
``conv.w_uploads``; float32 and float64 volumes get copies of their own;
the results equal the uncached path (the host matrix handed to
``conv_axis`` and copied on every call) bit for bit. A pyramid puts every
blur's operators there in one copy.
"""

import numpy as np
import pytest
import torch

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.ops import conv
from sift3d_tpu_torch.ops.gauss import gauss_taps
from sift3d_tpu_torch.utils import trace

torch.set_num_threads(1)

# Three axes of three lengths, so three matrices a conv_sep.
SHAPE = (2, 20, 24, 28)
UNITS = (1.0, 1.0, 1.0)


@pytest.fixture()
def empty_cache(monkeypatch):
    monkeypatch.setattr(conv, "_device_ops", {})


def _uploads(fn) -> int:
    before = trace.counters().get("conv.w_uploads", 0)
    fn()
    return trace.counters().get("conv.w_uploads", 0) - before


def _uncached(vol, taps, units):
    for axis, u in zip((-1, -2, -3), units):
        W = conv.conv_matrix(taps, 1.0, u, vol.shape[axis])
        vol = conv.conv_axis(vol, W, axis)
    return vol


def _bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("framed", [False, True], ids=["dense", "framed"])
def test_conv_sep_uploads_once_per_matrix(empty_cache, monkeypatch, framed):
    if framed:
        monkeypatch.setattr(conv, "BANDED_MIN_N", 1)
        monkeypatch.setattr(conv, "FRAME_TILE", 8)
    rng = np.random.default_rng(7)
    x32 = torch.as_tensor(rng.standard_normal(SHAPE).astype(np.float32))
    x64 = x32.double()
    taps = gauss_taps(1.3)
    out = {}
    # The first float32 call copies its three axes' operators, one copy
    # each; the same call again copies none.
    assert _uploads(lambda: out.setdefault(
        "a", conv.conv_sep(x32, taps, 1.0, UNITS))) == 3
    assert _uploads(lambda: out.setdefault(
        "b", conv.conv_sep(x32 * 2, taps, 1.0, UNITS))) == 0
    # float64 does not share float32's copies; then it has its own.
    assert _uploads(lambda: out.setdefault(
        "c", conv.conv_sep(x64, taps, 1.0, UNITS))) == 3
    assert _uploads(lambda: conv.conv_sep(x64, taps, 1.0, UNITS)) == 0
    # Other taps or units are other matrices: the x axis (n = 28) alone
    # changes its unit here.
    assert _uploads(lambda: conv.conv_sep(x32, taps, 1.0,
                                          (0.5, 1.0, 1.0))) == 1
    assert _uploads(lambda: conv.conv_sep(x32, gauss_taps(0.9), 1.0,
                                          UNITS)) == 3
    assert len(conv._device_ops) == 3 + 3 + 1 + 3
    assert {t.dtype for (_, _, dtype), t in conv._device_ops.items()
            if dtype == torch.float64} == {torch.float64}
    if framed:
        for k, v in (("a", x32), ("b", x32 * 2), ("c", x64)):
            got = v
            for axis, u in zip((-1, -2, -3), UNITS):
                H, tiles = conv.banded_frame_tiles(
                    conv.conv_matrix(taps, 1.0, u, v.shape[axis]), 8)
                got = conv._apply_frame_tiles(got, H, tiles, axis)
            assert _bitwise(out[k], got), k
    else:
        assert _bitwise(out["a"], _uncached(x32, taps, UNITS))
        assert _bitwise(out["b"], _uncached(x32 * 2, taps, UNITS))
        assert _bitwise(out["c"], _uncached(x64, taps, UNITS))


def test_pyramid_loads_every_blur_in_one_copy(empty_cache):
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid((28, 24, 20), UNITS, params)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        SHAPE).astype(np.float32))
    got = {}
    assert _uploads(lambda: got.setdefault(
        "g", tpyr.build_gpyr(tpyr.im_scale(x), plan))) == 1
    assert _uploads(lambda: tpyr.build_gpyr(tpyr.im_scale(x), plan)) == 0
    # The same levels as the blurs of host matrices copied each time.
    first = plan.first_level
    level = _uncached(tpyr.im_scale(x), plan.first_gauss_taps(),
                      plan.octave_units(0))
    assert _bitwise(got["g"][(0, first)], level)
    for s in range(first + 1, plan.last_gpyr_level + 1):
        level = _uncached(level, plan.octave_filter_taps(s),
                          plan.octave_units(0))
        assert _bitwise(got["g"][(0, s)], level), s


@pytest.mark.parametrize("framed", [False, True], ids=["dense", "framed"])
def test_pipelined_streamed_build_uploads_once(empty_cache, monkeypatch,
                                               framed):
    """A pipelined build sub-batch by sub-batch (``build_into``, as
    ``detect`` streams a stack) copies the plan's composed operators and
    first blur up once, in one copy, and the levels equal those of the
    composed host matrices copied on every call."""
    if framed:
        monkeypatch.setattr(conv, "BANDED_MIN_N", 1)
        monkeypatch.setattr(conv, "FRAME_TILE", 8)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid((28, 24, 20), UNITS, params)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4,) + SHAPE[1:]).astype(np.float32))
    slices = [slice(0, 1), slice(1, 3), slice(3, 4)]

    def streamed():
        gpyr, dog = {}, {}
        for sl in slices:
            tpyr.build_into(gpyr, dog, x[sl], sl, 4, plan, pipelined=True)
        return gpyr

    got = {}
    assert _uploads(lambda: got.setdefault("g", streamed())) == 1
    assert _uploads(streamed) == 0
    host_ops = tpyr.composed_pyramid_operators(plan)
    want = {}
    # The caller's own operators are host matrices, copied on every call.
    assert _uploads(lambda: want.setdefault("g", tpyr.build_gpyr_pipelined(
        tpyr.im_scale(x), plan, host_ops))) > len(host_ops[1])
    for key, level in want["g"].items():
        assert _bitwise(got["g"][key], level), key
