"""Port parity: RANSAC and pairwise registration.

``jax.random`` draws cannot be reproduced in torch, so the RANSAC tests
replay the JAX package's own hypothesis draws through the port's ``idx``
argument: the fitted affine must then agree within 1e-9 (float64 on both
sides) and the consensus set exactly. End to end, the port's
``RegSift3D(device="cpu").register`` must give the JAX package's matches
exactly, its affine within 1e-6 on the replayed draws, and an affine within
the reference's 5e-2 / 5-voxel contract on its own draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift3d_tpu.api import RegSift3D as JRegSift3D
from sift3d_tpu.config import RansacParams as JRansacParams
from sift3d_tpu.register.ransac import find_tform_ransac as jransac
from sift3d_tpu.register.ransac import tform_err_sq as jerr

from sift3d_tpu_torch import RegSift3D
from sift3d_tpu_torch.config import MatchParams, RansacParams
from sift3d_tpu_torch.register.pipeline import register_pair
from sift3d_tpu_torch.register.ransac import find_tform_ransac, tform_err_sq

from benches.data import SHIFT, make_volume, pair_ok
from tests.torch_helpers import jax_descriptors_to_port

torch.set_num_threads(1)


def jax_draws(params: RansacParams, count: int) -> np.ndarray:
    """The JAX package's hypothesis indices (find_tform_ransac's draws)."""
    n_hyp = params.num_iter * params.oversample
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(params.seed),
                                      (n_hyp, 4), jnp.float64))
    return np.minimum((u * np.float64(count)).astype(np.int32),
                      max(count - 1, 0))


def _correspondences(rng, n_in, n_out, n_pad, noise=0.08):
    A_true = np.array([[1.02, 0.03, -0.01, 4.0],
                       [-0.02, 0.98, 0.02, -2.5],
                       [0.01, -0.01, 1.05, 1.0]])
    ref = rng.random((n_in + n_out, 3)) * 100
    src = ref @ A_true[:, :3].T + A_true[:, 3]
    src[:n_in] += rng.normal(0, noise, (n_in, 3))
    src[n_in:] += rng.normal(0, 40.0, (n_out, 3))
    perm = rng.permutation(len(ref))
    pad = np.zeros((n_pad, 3))
    return (np.concatenate([src[perm], pad]), np.concatenate([ref[perm], pad]),
            A_true)


@pytest.mark.parametrize("n_in,n_out,n_pad,seed", [
    (60, 25, 15, 0),      # typical: inliers, gross outliers, padding rows
    (5, 2, 9, 3),         # tiny set: most draws repeat an index (singular)
])
def test_ransac_replayed_draws_match_jax(n_in, n_out, n_pad, seed):
    rng = np.random.default_rng(seed)
    src, ref, A_true = _correspondences(rng, n_in, n_out, n_pad)
    count = n_in + n_out
    jp = JRansacParams(seed=seed)
    want = jransac(jnp.asarray(src), jnp.asarray(ref), jnp.int32(count), jp)
    got = find_tform_ransac(
        torch.as_tensor(src), torch.as_tensor(ref), count,
        RansacParams(seed=seed),
        idx=torch.as_tensor(jax_draws(RansacParams(seed=seed), count)))
    np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    assert got.num_inliers == int(want.num_inliers)
    assert got.ok == bool(want.ok)
    assert got.effective_iters == int(want.effective_iters)
    np.testing.assert_allclose(
        tform_err_sq(got.A, torch.as_tensor(src), torch.as_tensor(ref)).numpy(),
        np.asarray(jerr(want.A, jnp.asarray(src), jnp.asarray(ref))),
        rtol=1e-9, atol=1e-9)
    if n_in >= 20:
        np.testing.assert_allclose(got.A.numpy(), A_true, atol=0.05)


def test_ransac_own_draws_fit_the_affine():
    rng = np.random.default_rng(1)
    src, ref, A_true = _correspondences(rng, 60, 25, 15)
    res = find_tform_ransac(torch.as_tensor(src), torch.as_tensor(ref), 85)
    again = find_tform_ransac(torch.as_tensor(src), torch.as_tensor(ref), 85)
    assert res.ok and res.num_inliers >= 55
    np.testing.assert_allclose(res.A.numpy(), A_true, atol=0.05)
    np.testing.assert_array_equal(res.A.numpy(), again.A.numpy())


class _KeepDescriptors(JRegSift3D):
    """The JAX RegSift3D, keeping the descriptor sets it registers."""

    def _detect_extract(self, im, units):
        desc = super()._detect_extract(im, units)
        self.descs.append(desc)
        return desc


@pytest.fixture(scope="module")
def pair_results():
    src = make_volume((48, 48, 48), nblob=60, seed=1)
    ref = np.roll(src, SHIFT, axis=2)
    jreg = _KeepDescriptors()
    jreg.descs = []
    want = jreg.register(src, ref)
    want.descs = jreg.descs
    reg = RegSift3D(device="cpu")
    got = reg.register(src, ref)
    return src, ref, want, reg, got


def test_register_on_jax_descriptors(pair_results):
    """The JAX package's own descriptor sets, carried across with
    convert.descriptors_from_numpy (with 16 of their padding rows), give
    the JAX matches in the port."""
    _, _, want, _, _ = pair_results
    d_src, d_ref = (jax_descriptors_to_port(d, pad=16) for d in want.descs)
    assert d_src.capacity == d_src.count + 16
    units = (1.0, 1.0, 1.0)
    for impl in ("xla", "streamed"):
        res = register_pair(d_src, d_ref, units, units, MatchParams(impl=impl))
        n = res.num_matches
        np.testing.assert_array_equal(res.match_src[:n].numpy(),
                                      want.match_src)
        np.testing.assert_array_equal(res.match_ref[:n].numpy(),
                                      want.match_ref)


def test_register_matches_exact(pair_results):
    _, _, want, _, got = pair_results
    assert len(want.match_src) >= 10
    np.testing.assert_array_equal(got.match_src, want.match_src)
    np.testing.assert_array_equal(got.match_ref, want.match_ref)
    assert not got.kp_overflow


def test_register_replayed_draws_match_jax(pair_results):
    src, ref, want, reg, _ = pair_results
    units = (1.0, 1.0, 1.0)
    _, d_src = reg.sift.detect_and_extract(src, units)
    _, d_ref = reg.sift.detect_and_extract(ref, units)
    idx = jax_draws(RansacParams(), len(want.match_src))
    res = register_pair(d_src, d_ref, units, units,
                        ransac_idx=torch.as_tensor(idx))
    np.testing.assert_allclose(res.A.numpy(), want.A, rtol=0, atol=1e-6)
    assert res.num_inliers == want.num_inliers and res.ok == want.ok


def test_register_within_contract(pair_results):
    _, _, want, _, got = pair_results
    assert want.ok and pair_ok(want.A)
    assert got.ok and pair_ok(got.A), got.A
