"""Port parity: the JAX package's small public helpers that no path of
either package calls (``gauss.incremental_taps``,
``PyramidPlan.gpyr_levels`` / ``dog_levels``, ``pyramid.Pyramid``,
``keypoints.concatenate``), each against the JAX package's on the same
inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features import keypoints as jkp
from sift3d_tpu.ops import gauss as jgauss

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.convert import keypoints_from_numpy
from sift3d_tpu_torch.features import keypoints as tkp
from sift3d_tpu_torch.ops import gauss as tgauss


@pytest.mark.parametrize("s_cur,s_next", [(1.6, 2.0159), (0.5, 1.6),
                                          (2.2, 4.4)])
def test_incremental_taps_equal(s_cur, s_next):
    np.testing.assert_array_equal(tgauss.incremental_taps(s_cur, s_next),
                                  jgauss.incremental_taps(s_cur, s_next))


def test_plan_level_walks_and_pyramid_equal():
    dims, units = (40, 24, 32), (1.0, 1.25, 2.0)
    jplan = jpyr.plan_pyramid(dims, units, JParams())
    tplan = tpyr.plan_pyramid(dims, units, SIFT3DParams())
    for walk in ("gpyr_levels", "dog_levels"):
        want = [dataclasses.asdict(g) for g in getattr(jplan, walk)()]
        got = [dataclasses.asdict(g) for g in getattr(tplan, walk)()]
        assert got == want and len(got) > 0, walk
    levels = {(0, -1): torch.zeros(2, 3, 4)}
    p = tpyr.Pyramid(tplan, levels)
    assert p.plan is tplan and dict(p) == levels
    assert jpyr.Pyramid(jplan, {}).plan is jplan


def _part(rng, cap, count):
    """Random rows exact in float32, whether or not JAX runs with x64."""
    def q(*shape):
        return rng.integers(0, 320, shape) / 8.0
    rows = dict(x=q(cap), y=q(cap), z=q(cap), o=rng.integers(0, 3, cap),
                s=rng.integers(0, 3, cap), sd=q(cap) + 1,
                R=(q(cap, 3, 3) - 20).astype(np.float32))
    return rows, count


def test_keypoints_concatenate_equal():
    rng = np.random.default_rng(8)
    parts = [_part(rng, 6, 4), _part(rng, 3, 0), _part(rng, 5, 5)]
    want = jkp.concatenate([
        jkp.Keypoints(**{k: jnp.asarray(v) for k, v in rows.items()},
                      count=jnp.int32(n)) for rows, n in parts])
    got = tkp.concatenate([keypoints_from_numpy(**rows, count=n)
                           for rows, n in parts])
    assert got.count == int(want.count) == 9
    assert got.capacity == want.capacity == 14
    for f in tkp.FIELDS:
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(
            g, np.asarray(getattr(want, f)).astype(g.dtype), err_msg=f)
