"""Port parity: the raw-image paths and the rest of the API surface.

``Sift3D.extract_raw`` and ``assign_orientations`` take a raw image and a
keypoint list: the JAX package's own keypoints are carried across
(``convert.keypoints_from_numpy``) and both packages describe and orient
them on the same image, at 32^3 and at an anisotropic 24x32x40 with units
(1, 1.5, 2). Descriptors must agree within 2e-3; the accepted orientation
set exactly, R and the confidence within 1e-5 (both sides sum the
structure tensor in float64 on the CPU). The reference's
rawDescriptorTest (< 0.2) and rawOrientationTest (median angle < pi/8)
bounds are held on the port alone; ``validate_keypoints``,
``descriptors_from_rows`` / ``match_descriptors`` and the resampled
registration (regAnisoTest) against the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift3d_tpu import api as japi
from sift3d_tpu.config import SIFT3DParams as JSIFT3DParams

from sift3d_tpu_torch import api
from sift3d_tpu_torch.io import Volume

from tests.conftest import make_blob_volume
from tests.torch_helpers import jax_keypoints_to_port, port_params

torch.set_num_threads(1)

# (shape (z, y, x), units (x, y, z), seed)
CASES = {"iso32": ((32, 32, 32), (1.0, 1.0, 1.0), 9),
         "aniso": ((24, 32, 40), (1.0, 1.5, 2.0), 9)}
JPARAMS = JSIFT3DParams(max_kp_per_level=1024)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX package's keypoints, raw descriptors and raw orientations
    of one volume, computed once."""
    shape, units, seed = CASES[request.param]
    vol = make_blob_volume(shape, seed=seed)
    sift = japi.Sift3D(JPARAMS)
    kp = sift.detect(vol, units)
    n = int(kp.count)
    assert n > 3
    desc = sift.extract_raw(vol, kp, units).to_numpy()[:n]
    R, conf = japi.assign_orientations(vol, kp, units, JPARAMS)
    return dict(vol=vol, units=units, kp=kp, n=n, desc=desc, R=R, conf=conf)


def test_extract_raw_matches_jax(case):
    kp = jax_keypoints_to_port(case["kp"])
    sift = api.Sift3D(port_params(JPARAMS), device="cpu")
    got = sift.extract_raw(case["vol"], kp, case["units"]).to_numpy()
    want = case["desc"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=1e-6)
    assert np.abs(got[:, 3:] - want[:, 3:]).max() <= 2e-3
    # A Volume's units override the argument.
    again = sift.extract_raw(Volume(case["vol"], case["units"]), kp,
                             (9.0, 9.0, 9.0)).to_numpy()
    np.testing.assert_array_equal(again, got)


def test_assign_orientations_matches_jax(case):
    kp = jax_keypoints_to_port(case["kp"])
    R, conf = api.assign_orientations(case["vol"], kp, case["units"],
                                      port_params(JPARAMS), device="cpu")
    R_j, conf_j = np.asarray(case["R"]), np.asarray(case["conf"])
    assert R.shape == R_j.shape and conf.dtype == np.float32
    np.testing.assert_array_equal(conf >= 0, conf_j >= 0)
    assert (conf >= 0).sum() > 0
    np.testing.assert_allclose(R, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(conf, conf_j, rtol=0, atol=1e-5)
    rejected = conf < 0
    assert (R[rejected] == np.eye(3, dtype=np.float32)).all()


def _angles_between(R1, R2):
    tr = np.einsum("kij,kij->k", R1, R2)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def test_raw_paths_agree_with_pyramid():
    """rawDescriptorTest (Sift3DTest.m:179-201) and rawOrientationTest
    (:205-242) on the port alone."""
    vol = make_blob_volume((32, 32, 32), seed=9)
    params = port_params(JPARAMS)
    sift = api.Sift3D(params, device="cpu")
    kp = sift.detect(vol)
    n = kp.count
    assert n > 3
    d_pyr = sift.extract(kp).to_numpy()
    d_raw = sift.extract_raw(vol, kp).to_numpy()
    np.testing.assert_allclose(d_raw[:, :3], d_pyr[:, :3], atol=1e-6)
    assert np.abs(d_raw[:, 3:] - d_pyr[:, 3:]).max() < 0.2
    R_raw, conf = api.assign_orientations(vol, kp, params=params,
                                          device="cpu")
    accepted = conf >= 0
    assert accepted.mean() > 0.5
    ang = _angles_between(kp.R.numpy()[accepted], R_raw[accepted])
    assert np.median(ang) < np.pi / 8


@pytest.mark.parametrize("kind", ["valid", "reflection", "scaled",
                                  "out_of_bounds"])
def test_validate_keypoints_raises_where_jax_raises(case, kind):
    """Both packages' sets with one row broken the same way: the port
    raises where the JAX package raises, with the same message."""
    R = np.asarray(case["kp"].R).copy()
    x = np.asarray(case["kp"].x).copy()
    if kind == "reflection":
        R[0] = np.diag([1.0, 1.0, -1.0])
    elif kind == "scaled":
        R[0] = np.eye(3) * 2.0
    elif kind == "out_of_bounds":
        x[1] = 1e4
    kp_j = dataclasses.replace(case["kp"], R=jnp.asarray(R),
                               x=jnp.asarray(x))
    kp_p = jax_keypoints_to_port(kp_j)
    dims = case["vol"].shape[::-1]

    def outcome(fn, kp):
        try:
            fn(kp, dims_xyz=dims)
        except ValueError as e:
            return str(e)
        return None
    want = outcome(japi.validate_keypoints, kp_j)
    assert (want is None) == (kind == "valid")
    assert outcome(api.validate_keypoints, kp_p) == want


def test_descriptor_rows_match_like_jax():
    """The matchSift3D workflow: descriptor rows (as read from CSV) into
    sets, then matched, as the JAX package matches them."""
    rng = np.random.default_rng(42)
    d1 = rng.random((20, 768)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([d1[:10], rng.random((15, 768)).astype(np.float32)])
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    rows1 = np.concatenate([rng.random((20, 3)), d1], axis=1)
    rows2 = np.concatenate([rng.random((25, 3)), d2], axis=1)
    want = japi.match_descriptors(japi.descriptors_from_rows(rows1),
                                  japi.descriptors_from_rows(rows2, 32))
    p1 = api.descriptors_from_rows(rows1, device="cpu")
    p2 = api.descriptors_from_rows(rows2, 32, device="cpu")
    assert p2.capacity == 32 and p2.count == 25
    got = api.match_descriptors(p1, p2)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:10] == np.arange(10)).all()
    with pytest.raises(ValueError):
        api.descriptors_from_rows(rows1[:, :100], device="cpu")


def test_register_resample_matches_jax():
    """regAnisoTest (Sift3DTest.m:332-358): drop every other z slice,
    double the z unit, register with resample. The port's matches equal
    the JAX package's; its affine meets the 5e-2 / 5-voxel contract."""
    vol = make_blob_volume((48, 48, 48), seed=4)
    aniso = vol[::2]
    want = japi.RegSift3D(JPARAMS).register(
        vol, aniso, ref_units=(1.0, 1.0, 2.0), resample=True)
    reg = api.RegSift3D(port_params(JPARAMS), device="cpu")
    got = reg.register(Volume(vol), Volume(aniso, (1.0, 1.0, 2.0)),
                       resample=True)
    assert got.ok and not got.kp_overflow
    np.testing.assert_allclose(got.A[:, :3], np.diag([1.0, 1.0, 2.0]),
                               atol=5e-2)
    np.testing.assert_allclose(got.A[:, 3], 0.0, atol=5.0)
    assert len(got.match_src) == len(want.match_src) > 0
    np.testing.assert_allclose(got.match_src, want.match_src, atol=1e-6)
    np.testing.assert_allclose(got.match_ref, want.match_ref, atol=1e-6)
