"""Port parity: the framed-banded convolution (``ops/conv.py``).

The same numpy inputs go through ``sift3d_tpu.ops.conv`` (JAX, CPU,
eager) and ``sift3d_tpu_torch.ops.conv`` (plain PyTorch, CPU). The host
tables (half-widths, frame tiles) are equal bit for bit; the framed form
equals JAX's within 1e-6 and the port's own dense form within 2e-5 (the
bound of ``tests/test_conv_pyramid.py``). With ``BANDED_MIN_N`` lowered
to 1 in both packages, ``conv_sep``, both pyramid builders and dense
descriptors keep the existing parity contracts: levels within 1e-5,
extrema rows exact, descriptors within 2e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features import dense as jdense
from sift3d_tpu.features import detect as jdetect
from sift3d_tpu.ops import conv as jconv
from sift3d_tpu.ops.gauss import gauss_taps

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features import dense as tdense
from sift3d_tpu_torch.features import detect as tdetect
from sift3d_tpu_torch.ops import conv as tconv

from tests.conftest import make_blob_volume

torch.set_num_threads(1)

# (shape, axis, unit_dim): 300 samples along one axis: JAX's 3 tiles of 128
# (n_pad 384) and the port's 5 of 64, the last one cut at n.
LONG = [((300, 6, 5), 0, 1.0), ((5, 300, 6), 1, 0.7), ((6, 5, 300), 2, 1.9)]
SIGMAS = (2.2, 2.83)
PYR_SHAPE = (8, 10, 260)            # (nz, ny, nx): x is the long axis
OPS_SHAPE = (16, 16, 300)           # two octaves: x 300, then 150 long
PYR_UNITS = (1.0, 1.0, 1.0)


@pytest.mark.parametrize("sigma,unit,n", [(2.2, 1.0, 300), (2.83, 0.7, 300),
                                          (1.6, 1.9, 64), (2.83, 1.0, 512)])
def test_band_tables_equal(sigma, unit, n):
    taps = gauss_taps(sigma)
    assert tconv.unit_half_width(len(taps), 1.0, unit) == \
        jconv.unit_half_width(len(taps), 1.0, unit)
    W = tconv.conv_matrix(taps, 1.0, unit, n)
    assert tconv.band_half_width(W) == jconv.band_half_width(W)
    for tile in (128, 16):
        (th, tt), (jh, jt) = (tconv.banded_frame_tiles(W, tile),
                              jconv.banded_frame_tiles(W, tile))
        assert th == jh
        assert tt.dtype == jt.dtype == np.float32
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("shape,axis,unit", LONG)
def test_conv_axis_banded_matches_jax(shape, axis, unit, sigma):
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    taps = gauss_taps(sigma)
    want = np.asarray(jconv.conv_axis_banded(jnp.asarray(vol), taps, 1.0,
                                             unit, axis))
    got = tconv.conv_axis_banded(torch.as_tensor(vol), taps, 1.0, unit, axis)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    dense = tconv.conv_axis(torch.as_tensor(vol),
                            tconv.conv_matrix(taps, 1.0, unit, shape[axis]),
                            axis)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=2e-5)


def _long_axis_ops(tile):
    """The square composed operators of a plan on the long axis (x), split
    by whether ``apply_banded_matrix`` frames them at ``tile``."""
    plan = tpyr.plan_pyramid(OPS_SHAPE[::-1], PYR_UNITS, SIFT3DParams())
    _, level_ops = tpyr.composed_pyramid_operators(plan)
    frames, falls_back = [], []
    for key, ops in sorted(level_ops.items()):
        W = ops[0]
        n = W.shape[0]
        wide = min(tile, n) + 2 * tconv.band_half_width(W) >= n
        (falls_back if wide else frames).append((key, W))
    return frames, falls_back


@pytest.mark.parametrize("tile,branch", [("jax", "frames"),
                                         ("jax", "falls_back"),
                                         ("port", "frames")])
def test_apply_banded_matrix_composed_matches_jax(tile, branch,
                                                  monkeypatch):
    """At JAX's tile both packages take the same branch; at the port's
    own tile its framed result still equals JAX's."""
    if tile == "jax":
        monkeypatch.setattr(tconv, "FRAME_TILE", jconv.FRAME_TILE)
    frames, falls_back = _long_axis_ops(tconv.FRAME_TILE)
    key, W = (frames if branch == "frames" else falls_back)[-1]
    n = W.shape[0]
    vol = np.random.default_rng(5).standard_normal((4, 3, n)).astype(
        np.float32)
    want = np.asarray(jconv.apply_banded_matrix(jnp.asarray(vol), W, -1))
    got = tconv.apply_banded_matrix(torch.as_tensor(vol), W, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                               err_msg=str(key))
    dense = tconv.conv_axis(torch.as_tensor(vol), W, -1)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=2e-5)


@pytest.fixture
def forced(monkeypatch):
    """The framed form on every axis of either package."""
    monkeypatch.setattr(jconv, "BANDED_MIN_N", 1)
    monkeypatch.setattr(tconv, "BANDED_MIN_N", 1)


def test_conv_sep_forced_matches_jax(forced):
    vol = make_blob_volume(PYR_SHAPE, seed=9)
    taps = gauss_taps(1.6)
    units = (1.0, 1.3, 0.8)
    want = np.asarray(jconv.conv_sep(jnp.asarray(vol), taps, 1.0, units))
    got = tconv.conv_sep(torch.as_tensor(vol), taps, 1.0, units)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("builder", ["build_gpyr", "build_gpyr_pipelined"])
def test_pyramid_forced_matches_jax(forced, builder):
    vol = make_blob_volume(PYR_SHAPE, seed=7)
    nz, ny, nx = PYR_SHAPE
    jplan = jpyr.plan_pyramid((nx, ny, nz), PYR_UNITS, JParams())
    tplan = tpyr.plan_pyramid((nx, ny, nz), PYR_UNITS, SIFT3DParams())
    jg = getattr(jpyr, builder)(jpyr.im_scale(jnp.asarray(vol)), jplan)
    tg = getattr(tpyr, builder)(tpyr.im_scale(torch.as_tensor(vol)), tplan)
    assert sorted(jg) == sorted(tg)
    for key in jg:
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                   rtol=0, atol=1e-5, err_msg=str(key))
    jext = jdetect.detect_extrema_levels(jpyr.build_dog(jg, jplan), jplan,
                                         JParams())
    text = tdetect.detect_extrema_levels(tpyr.build_dog(tg, tplan), tplan,
                                         SIFT3DParams())
    n_total = 0
    for key in jext:
        jzyx, jcount, jtotal = jext[key]
        tzyx, tcount, ttotal = text[key]
        assert (tcount, ttotal) == (int(jcount), int(jtotal)), key
        np.testing.assert_array_equal(tzyx.numpy(),
                                      np.asarray(jzyx)[:int(jcount)])
        n_total += tcount
    assert n_total > 5, "too few extrema to be a real test"


def test_dense_forced_matches_jax(forced):
    vol = make_blob_volume((8, 8, 136), seed=13)
    want = np.asarray(jdense.extract_dense_descriptors(
        jnp.asarray(vol), (1.0, 1.0, 1.0), JParams()))
    got = tdense.extract_dense_descriptors(torch.as_tensor(vol),
                                           (1.0, 1.0, 1.0), SIFT3DParams())
    assert got.shape == (12,) + vol.shape
    assert np.abs(got.numpy() - want).max() <= 2e-3
    assert np.abs(want).max() > 0.1


def _table(framed):
    """A crossover table (``scripts/conv_banded_ab.crossover``'s rows)
    with dense at 1 ms and ``framed(n, T, axis)`` ms."""
    return [dict(n=n, taps=taps, axis=axis, dense=dict(min_ms=1.0),
                 framed={T: dict(min_ms=framed(n, T, axis))
                         for T in (64, 128, 256)})
            for n in (128, 192, 256, 384, 512)
            for taps in ("pyramid_widest", "dense_blur")
            for axis in ("x", "y", "z")]


@pytest.mark.parametrize("framed,want", [
    # Never 5% faster: the sentinel, and the tile stays 128.
    (lambda n, T, a: 0.96, (10 ** 9, 128)),
    # Faster from 256 on, but one axis at 384 is not: only 512 counts.
    (lambda n, T, a: 1.2 if n < 256 or (n == 384 and a == "x") else 0.8,
     (512, 128)),
    # Faster from 384 on; 64 within 5% of 128 at 512, so 128 stays.
    (lambda n, T, a: (0.9 if n >= 384 else 1.1) * (0.97 if T == 64 else 1),
     (384, 128)),
    # 64 at most 0.9 of 128 wherever the framed form is chosen.
    (lambda n, T, a: (0.7 if n >= 384 else 1.1) * (0.9 if T == 64 else 1),
     (384, 64)),
    # 64 is 4% slower than 128 on the z axis at 384 and 15% faster on the
    # other rows: the tile moves only where it wins on every row, so 128
    # stays although 64's total is 0.88 of 128's.
    (lambda n, T, a: (0.7 if n >= 384 else 1.1) *
     ((1.04 if (n, a) == (384, "z") else 0.85) if T == 64 and n >= 384
      else 1),
     (384, 128)),
])
def test_crossover_rule(framed, want):
    from scripts.conv_banded_ab import pick
    assert pick(_table(framed)) == want
