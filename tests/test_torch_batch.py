"""Port parity: the batched config-4 path (``parallel.pipeline``).

The JAX package's ``batch_detect_describe`` on a one-device mesh (its
unsharded branch), followed by ``batch_register_pairs``' own body (the
vmapped ``register_pair`` of ``sift3d_tpu/parallel/pipeline.py:305-310``,
so that the JAX detection runs once per side), and the port's functions
with ``device="cpu"`` take the same B = 2 volume pairs: per-volume
keypoint rows exact (R within 1e-5), descriptors within 2e-3, matches
exact per pair, the affine within 1e-6 when the port replays the JAX
package's RANSAC draws, and ``kp_overflow`` equal, at ample caps and at
``max_kp_per_level=1`` (the case of ``tests/test_parallel.py``). The src
stack's keypoint rows are also exact with its pyramid built one volume a
sub-batch (``tests/torch_helpers.sub_batched``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import MatchParams as JMatchParams
from sift3d_tpu.config import RansacParams as JRansacParams
from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.parallel import make_mesh
from sift3d_tpu.parallel import pipeline as jpipe
from sift3d_tpu.register.pipeline import register_pair as jregister_pair

from sift3d_tpu_torch import RegSift3D
from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.convert import volume
from sift3d_tpu_torch.features.detect import detect
from sift3d_tpu_torch.features.descriptor import level_buckets, level_geometry
from sift3d_tpu_torch.ops.cuda_window import descrip_window_plain
from sift3d_tpu_torch.parallel import pipeline as tpipe
from sift3d_tpu_torch.register.pipeline import register_pairs

from benches.data import make_pairs
from tests.conftest import make_blob_volume
from tests.torch_helpers import (jax_keypoints_to_port, keypoint_rows,
                                 port_params, sub_batched)
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

SHAPE = (40, 40, 40)
UNITS = (1.0, 1.0, 1.0)
# Per-octave caps above these volumes' largest level counts (31, 20, 10):
# no truncation, and the JAX package's static-capacity windows stay small.
JPARAMS = JParams(max_kp_per_level=32, max_kp_per_octave=(32, 24, 12))
JRANSAC = JRansacParams(num_iter=50)


@pytest.fixture(scope="module")
def batch():
    src, ref = make_pairs(2, SHAPE, nblob=60)
    jparams = JPARAMS
    jplan = jpyr.plan_pyramid(SHAPE[::-1], UNITS, jparams)
    mesh = make_mesh(jax.devices()[:1], data=1, space=1)
    jkp, jdesc, jov = jpipe.batch_detect_describe(jnp.asarray(src), jplan,
                                                  jparams, mesh)
    _, jdesc_ref, jov_ref = jpipe.batch_detect_describe(
        jnp.asarray(ref), jplan, jparams, mesh)
    jres = jax.vmap(lambda ds, dr: jregister_pair(
        ds, dr, UNITS, UNITS, JMatchParams(), JRANSAC))(jdesc, jdesc_ref)
    jres = dataclasses.replace(jres, kp_overflow=jov | jov_ref)
    params = port_params(jparams)
    plan = tpyr.plan_pyramid(SHAPE[::-1], UNITS, params)
    kp, desc, ov = tpipe.batch_detect_describe(src, plan, params,
                                               device="cpu")
    res = tpipe.batch_register_pairs(src, ref, plan, params,
                                     ransac_params=port_params(JRANSAC),
                                     device="cpu")
    return dict(src=src, ref=ref, plan=plan, params=params,
                jkp=jkp, jdesc=jdesc, jov=np.asarray(jov), jres=jres,
                kp=kp, desc=desc, ov=ov, res=res)


def test_keypoint_rows_exact_per_volume(batch):
    jkp = jax_keypoints_to_port(batch["jkp"])
    assert batch["kp"].count.tolist() == jkp.count.tolist()
    for b in range(2):
        want = keypoint_rows(volume(jkp, b))
        got = keypoint_rows(volume(batch["kp"], b))
        assert want.shape[0] >= 15, "too few keypoints to be a real test"
        np.testing.assert_array_equal(got[:, :6], want[:, :6])
        np.testing.assert_allclose(got[:, 6:], want[:, 6:], rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def streamed_kp(batch):
    """The port's keypoints of the src stack with its pyramid built one
    volume a sub-batch, as a host stack streams to a card."""
    with sub_batched(4 * int(np.prod(SHAPE))):
        kp, _, _ = tpipe.batch_detect_describe(
            batch["src"], batch["plan"], batch["params"], device="cpu")
    return kp


@pytest.mark.parametrize("against", ["jax", "whole_batch"])
def test_streamed_keypoint_rows_exact_per_volume(batch, streamed_kp,
                                                 against):
    want_kp = jax_keypoints_to_port(batch["jkp"]) if against == "jax" \
        else batch["kp"]
    assert streamed_kp.count.tolist() == want_kp.count.tolist()
    for b in range(2):
        want = keypoint_rows(volume(want_kp, b))
        got = keypoint_rows(volume(streamed_kp, b))
        assert want.shape[0] >= 15, "too few keypoints to be a real test"
        np.testing.assert_array_equal(got[:, :6], want[:, :6])
        np.testing.assert_allclose(got[:, 6:], want[:, 6:], rtol=0,
                                   atol=1e-5)


def test_descriptors_per_volume(batch):
    jvec, jcount = np.asarray(batch["jdesc"].vec), np.asarray(
        batch["jdesc"].count)
    jxyz = np.asarray(batch["jdesc"].xyz)
    for b in range(2):
        got = volume(batch["desc"], b)
        n = int(jcount[b])
        assert got.count == n
        np.testing.assert_array_equal(got.xyz.numpy(), jxyz[b, :n])
        np.testing.assert_allclose(got.vec.numpy(), jvec[b, :n], rtol=0,
                                   atol=2e-3)


def test_matches_exact_per_pair(batch):
    jres, res = batch["jres"], batch["res"]
    jm, jn = np.asarray(jres.matches), np.asarray(jres.num_matches)
    assert res.num_matches.tolist() == jn.tolist()
    assert min(jn) >= 10, "too few matches to be a real test"
    for b in range(2):
        n = int(batch["desc"].count[b])
        np.testing.assert_array_equal(res.matches[b, :n].numpy(), jm[b, :n])
        np.testing.assert_array_equal(res.match_src[b, :jn[b]].numpy(),
                                      np.asarray(jres.match_src)[b, :jn[b]])


def test_affine_on_replayed_draws(batch):
    """Each pair replays the JAX package's draws for its own match count
    (the vmapped JAX fit scales one set of uniforms by each count)."""
    jres = batch["jres"]
    params = port_params(JRANSAC)
    idx = torch.as_tensor(np.stack([jax_draws(params, int(n))
                                    for n in np.asarray(jres.num_matches)]))
    _, d_ref, _ = tpipe.batch_detect_describe(
        batch["ref"], batch["plan"], batch["params"], device="cpu")
    res = register_pairs(batch["desc"], d_ref, UNITS, UNITS,
                         ransac_params=params, ransac_idx=idx)
    np.testing.assert_allclose(res.A.numpy(), np.asarray(jres.A), rtol=0,
                               atol=1e-6)
    assert res.num_inliers.tolist() == np.asarray(jres.num_inliers).tolist()
    assert res.ok.tolist() == np.asarray(jres.ok).tolist()


def test_kp_overflow_equal(batch):
    assert batch["ov"].tolist() == batch["jov"].tolist() == [False, False]
    assert batch["res"].kp_overflow.tolist() == \
        np.asarray(batch["jres"].kp_overflow).tolist()


@pytest.fixture(scope="module")
def cap_one():
    """The dense/near-empty pair of tests/test_parallel.py at
    max_kp_per_level=1, and the JAX package's overflow flags for it."""
    dense_vol = make_blob_volume((16, 16, 16), seed=7)
    empty_vol = np.zeros((16, 16, 16), np.float32)
    empty_vol[6:10, 6:10, 6:10] = 1.0
    vols = np.stack([dense_vol, empty_vol])
    jparams = JParams(max_kp_per_level=1)
    jplan = jpyr.plan_pyramid((16, 16, 16), UNITS, jparams)
    mesh = make_mesh(jax.devices()[:1], data=1, space=1)
    _, _, jov = jpipe.batch_detect_describe(jnp.asarray(vols), jplan,
                                            jparams, mesh)
    return vols, port_params(jparams), np.asarray(jov)


def test_kp_overflow_at_cap_one(cap_one):
    """The dense volume reports truncation in both packages, and the flag
    reaches batch_register_pairs' result."""
    vols, params, jov = cap_one
    plan = tpyr.plan_pyramid((16, 16, 16), UNITS, params)
    _, _, ov = tpipe.batch_detect_describe(vols, plan, params, device="cpu")
    assert ov.tolist() == jov.tolist()
    assert ov.tolist()[0]
    res = tpipe.batch_register_pairs(vols, vols, plan, params,
                                     ransac_params=port_params(
                                         JRansacParams(num_iter=20)),
                                     device="cpu")
    assert res.kp_overflow.tolist() == ov.tolist()


def test_batched_descrip_window_equals_per_volume(batch):
    """Kernel 1's plain version on the rows of both volumes of every level
    bucket at once equals its per-volume calls."""
    plan = batch["plan"]
    gpyr, kp, vol, _ = detect(batch["src"], plan, batch["params"],
                              torch.device("cpu"))
    assert vol.unique().tolist() == [0, 1]
    for (o, s), rows in level_buckets(kp, plan):
        sigma, rad, radii, cores = level_geometry(
            plan.gpyr_level(o, s).scale, plan.octave_units(o),
            gpyr[(o, s)].shape[-3:])
        geom = (radii, cores, plan.octave_units(o), sigma, rad)
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]],
                              -1).float()
        R, v = kp.R[rows], vol[rows]
        got = descrip_window_plain(gpyr[(o, s)], centers, R, len(rows),
                                   *geom, vol=v)
        for b in v.unique().tolist():
            m = v == b
            want = descrip_window_plain(gpyr[(o, s)][b], centers[m], R[m],
                                        int(m.sum()), *geom)
            torch.testing.assert_close(got[m], want, rtol=0, atol=0)


def test_register_without_keypoints():
    """Volumes with no keypoints register to ok=False with no matches, one
    pair at a time and batched (the dense matcher once raised on an empty
    set)."""
    vols = np.zeros((2, 16, 16, 16), np.float32)
    params = port_params(JParams())
    plan = tpyr.plan_pyramid((16, 16, 16), UNITS, params)
    res = tpipe.batch_register_pairs(
        vols, vols, plan, params,
        ransac_params=port_params(JRansacParams(num_iter=20)), device="cpu")
    assert res.num_matches.tolist() == [0, 0] and not res.ok.any()
    one = RegSift3D(device="cpu").register(vols[0], vols[0])
    assert not one.ok and len(one.match_src) == 0
