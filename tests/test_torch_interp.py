"""Port parity: warping, resampling and drawing.

``ops/interp.py`` (trilinear and Lanczos-2 sampling, ``im_inv_transform``,
``im_resample``) is plain torch arithmetic in float64, as the JAX package
computes it with x64 on: on seeded random volumes and affines that reach
outside the volume, the port's results lie within 1e-6 of the volume's
largest |value| of the JAX package's. ``resample_dims`` and the numpy
drawing helpers (copied, ``ops/draw.py``) are array-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d_tpu.ops import draw as jdraw
from sift3d_tpu.ops import interp as jinterp

from sift3d_tpu_torch.ops import draw, interp

torch.set_num_threads(1)

SHAPE = (11, 13, 9)


def _volume(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def _affine(seed):
    """A rotation-and-scale affine about the centre, shifted far enough
    that part of the output grid samples outside the volume."""
    rng = np.random.default_rng(seed)
    L = np.eye(3) + rng.normal(0, 0.15, (3, 3))
    t = rng.uniform(-3.0, 3.0, 3)
    return np.concatenate([L, t[:, None]], 1)


def _close(got, want, vol):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() <= \
        1e-6 * np.abs(vol).max()


@pytest.mark.parametrize("sampler", ["sample_linear", "sample_lanczos2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_match_jax(sampler, seed):
    vol = _volume(seed)
    A = _affine(seed)
    want = getattr(jinterp, sampler)(
        jnp.asarray(vol), *jinterp.apply_affine_grid(jnp.asarray(A), SHAPE))
    xs, ys, zs = interp.apply_affine_grid(A, SHAPE)
    got = getattr(interp, sampler)(torch.as_tensor(vol), xs, ys, zs)
    assert got.dtype == torch.float32
    inside = ((xs >= 0) & (xs <= SHAPE[2] - 1) & (ys >= 0) &
              (ys <= SHAPE[1] - 1) & (zs >= 0) & (zs <= SHAPE[0] - 1))
    assert 0 < int(inside.sum()) < inside.numel()     # in and out of bounds
    assert (got[~inside] == 0).all()
    _close(got, want, vol)


@pytest.mark.parametrize("interp_name", ["linear", "lanczos2"])
@pytest.mark.parametrize("out_shape", [None, (7, 15, 10)])
def test_im_inv_transform_matches_jax(interp_name, out_shape, monkeypatch):
    vol = _volume(3)
    A = _affine(3)
    want = jinterp.im_inv_transform(jnp.asarray(A), jnp.asarray(vol),
                                    out_shape, interp_name)
    got = interp.im_inv_transform(A, torch.as_tensor(vol), out_shape,
                                  interp_name)
    _close(got, want, vol)
    # Taken a few planes at a time, the warp is the same.
    monkeypatch.setattr(interp, "SLAB_VOXELS", 2 * SHAPE[1] * SHAPE[2])
    slabbed = interp.im_inv_transform(A, torch.as_tensor(vol), out_shape,
                                      interp_name)
    assert torch.equal(slabbed, got)


@pytest.mark.parametrize("units_old,units_new", [
    ((1.0, 1.0, 2.0), (1.0, 1.0, 1.0)),
    ((0.7, 1.3, 1.0), (1.0, 1.0, 0.5)),
])
@pytest.mark.parametrize("interp_name", ["linear", "lanczos2"])
def test_im_resample_matches_jax(units_old, units_new, interp_name):
    vol = _volume(4)
    assert interp.resample_dims(SHAPE, units_old, units_new) == \
        jinterp.resample_dims(SHAPE, units_old, units_new)
    want = jinterp.im_resample(jnp.asarray(vol), units_old, units_new,
                               interp_name)
    got = interp.im_resample(torch.as_tensor(vol), units_old, units_new,
                             interp_name)
    _close(got, want, vol)


def test_resample_dims_equal():
    for dims, uo, un in [((24, 48, 48), (1, 1, 2), (1, 1, 1)),
                         ((10, 11, 12), (0.3, 0.7, 1.1), (0.5, 0.5, 0.5)),
                         ((5, 5, 5), (2, 2, 2), (3, 3, 3))]:
        assert interp.resample_dims(dims, uo, un) == \
            jinterp.resample_dims(dims, uo, un)


def test_draw_functions_equal():
    rng = np.random.default_rng(5)
    dims = (14, 12, 10)
    p1 = rng.uniform(0, 9, (6, 3))
    p2 = rng.uniform(0, 9, (6, 3))
    np.testing.assert_array_equal(draw.draw_grid(dims, 4, 1),
                                  jdraw.draw_grid(dims, 4, 1))
    np.testing.assert_array_equal(draw.draw_points(p1, dims, 1),
                                  jdraw.draw_points(p1, dims, 1))
    np.testing.assert_array_equal(draw.draw_lines(p1, p2, dims),
                                  jdraw.draw_lines(p1, p2, dims))
    src = rng.random((10, 12, 14)).astype(np.float32)
    ref = rng.random((8, 12, 16)).astype(np.float32)
    got = draw.draw_matches(src, ref, p1, p2)
    want = jdraw.draw_matches(src, ref, p1, p2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
