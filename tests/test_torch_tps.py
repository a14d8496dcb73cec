"""Port parity: thin-plate spline registration.

The same seeded inputs go through ``sift3d_tpu/register/tps.py`` and
``sift3d_tpu_torch/register/tps.py``: the fitted parameters agree within
1e-9 of their largest value (float64 solves on both sides), the applied
map within 1e-9 mm, and the TPS warp within 1e-6 of the volume's largest
value. End to end, ``register_pair_tps`` on the 48^3 shifted pair replays
the JAX package's RANSAC draws (``jax_draws``) and must give the same
matches, inlier count and TPS parameters within 1e-6; on its own draws it
must map a deep-interior probe grid within 1.5 voxels of the shift.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.api import RegSift3D as JRegSift3D
from sift3d_tpu.config import SIFT3DParams as JSIFT3DParams
from sift3d_tpu.register import tps as jtps

from sift3d_tpu_torch import RegSift3D
from sift3d_tpu_torch.config import RansacParams, SIFT3DParams
from sift3d_tpu_torch.register import tps as ptps

from tests.conftest import make_blob_volume
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

SHIFT = 3


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(42)
    ctrl = rng.random((20, 3)) * 50
    targets = ctrl + rng.normal(0, 3.0, (20, 3))
    pts = rng.random((30, 3)) * 60 - 5
    out = {}
    for reg in (0.0, 1e-6):
        j = jtps.fit_tps(ctrl, targets, reg=reg)
        p = ptps.fit_tps(torch.as_tensor(ctrl), torch.as_tensor(targets),
                         reg=reg)
        out[reg] = (j, p)
    return ctrl, targets, pts, out


@pytest.mark.parametrize("reg", [0.0, 1e-6])
def test_fit_tps_matches_jax(fitted, reg):
    ctrl, targets, _, out = fitted
    j, p = out[reg]
    assert p.params.dtype == torch.float64 and p.params.shape == (3, 24)
    assert _rel(p.params.numpy(), np.asarray(j.params)) <= 1e-9
    np.testing.assert_array_equal(p.ctrl.numpy(), np.asarray(j.ctrl))
    if reg == 0.0:
        np.testing.assert_allclose(ptps.tps_apply(p, ctrl).numpy(), targets,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("reg", [0.0, 1e-6])
def test_tps_apply_matches_jax(fitted, reg):
    _, _, pts, out = fitted
    j, p = out[reg]
    want = np.asarray(jtps.tps_apply(j, jnp.asarray(pts)))
    got = ptps.tps_apply(p, torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # Leading axes pass through, as in JAX.
    got2 = ptps.tps_apply(p, torch.as_tensor(pts.reshape(5, 6, 3))).numpy()
    np.testing.assert_array_equal(got2.reshape(30, 3), got)


def test_u_is_zero_at_zero():
    r = torch.tensor([0.0, 1.0, np.e, 4.0], dtype=torch.float64)
    np.testing.assert_allclose(ptps._u(r).numpy(),
                               [0.0, 0.0, np.e, 4.0 * np.log(4.0)])


@pytest.mark.parametrize("interp,units", [
    ("linear", ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))),
    ("linear", ((1.0, 1.3, 0.8), (0.9, 1.0, 1.2))),
    ("lanczos2", ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))),
])
def test_im_inv_transform_tps_matches_jax(interp, units, monkeypatch):
    """The TPS warp on a 20 x 18 x 22 volume, the output grid taken in
    several chunks on the port's side."""
    rng = np.random.default_rng(7)
    vol = make_blob_volume((20, 18, 22), seed=9)
    ctrl = rng.random((12, 3)) * np.array([22.0, 18.0, 20.0])
    targets = ctrl + rng.normal(0, 1.5, (12, 3)) + np.array([1.0, -0.5, 0.3])
    j = jtps.fit_tps(ctrl, targets, reg=1e-6)
    p = ptps.Tps(params=torch.as_tensor(np.array(j.params)),
                 ctrl=torch.as_tensor(np.array(j.ctrl)))
    su, ru = units
    want = np.asarray(jtps.im_inv_transform_tps(
        j, jnp.asarray(vol), (19, 18, 23), interp, su, ru))
    monkeypatch.setattr(ptps, "_CHUNK_ENTRIES", 12 * 1000)
    got = ptps.im_inv_transform_tps(p, torch.as_tensor(vol), (19, 18, 23),
                                    interp, su, ru).numpy()
    assert got.shape == want.shape == (19, 18, 23)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(vol).max()


@pytest.fixture(scope="module")
def pair_tps():
    """Both packages' register_tps on the 48^3 shifted pair; the port once
    on the JAX package's draws and once on its own."""
    src = make_blob_volume((48, 48, 48), seed=17)
    ref = np.roll(src, SHIFT, axis=2)
    jres, jt = JRegSift3D(JSIFT3DParams(max_kp_per_level=1024)).register_tps(
        src, ref)
    reg = RegSift3D(SIFT3DParams(max_kp_per_level=1024), device="cpu")
    n = len(jres.match_src)
    replayed = reg.register_tps(src, ref,
                                ransac_idx=jax_draws(RansacParams(), n))
    own = reg.register_tps(src, ref)
    return (jres, jt), replayed, own


def test_register_tps_replayed_draws_match_jax(pair_tps):
    (jres, jt), (pres, pt), _ = pair_tps
    assert jt is not None and pt is not None and pres.ok and jres.ok
    np.testing.assert_array_equal(pres.match_src, jres.match_src)
    np.testing.assert_array_equal(pres.match_ref, jres.match_ref)
    assert pres.num_inliers == jres.num_inliers
    assert pt.ctrl.shape[0] == np.asarray(jt.ctrl).shape[0] >= 5
    np.testing.assert_allclose(pt.ctrl.numpy(), np.asarray(jt.ctrl),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt.params.numpy(), np.asarray(jt.params),
                               rtol=0, atol=1e-6)


def test_register_tps_own_draws_recover_the_shift(pair_tps):
    *_, (res, t) = pair_tps
    assert t is not None and res.ok
    g = np.stack(np.meshgrid(*[np.arange(18, 31, 6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(float)
    mapped = ptps.tps_apply(t, torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(mapped, g + np.array([-SHIFT, 0.0, 0.0]),
                               atol=1.5)


def test_register_tps_without_a_model():
    """A featureless pair gives no model and no spline."""
    vol = np.zeros((16, 16, 16), np.float32)
    res, t = RegSift3D(device="cpu").register_tps(vol, vol)
    assert t is None and not res.ok
