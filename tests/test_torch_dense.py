"""Port parity: dense descriptors (``Sift3D.dense``, config 3).

The same seeded volumes go through ``sift3d_tpu.features.dense`` and
``sift3d_tpu_torch.features.dense`` (JAX outputs computed once for the
module): the default splat-and-blur path at 24 x 20 x 28 and at an
anisotropic 16 x 24 x 20 with units (1, 1.3, 2), and the rotation-invariant
path (``dense_rotate``) at 14 x 12 x 16, each within the 2e-3 descriptor
contract. The channel-sequential form (above ``DENSE_CHANNEL_SEQ_VOX``,
switched on here by lowering the threshold in the port's module only)
equals the all-at-once form; the rotate path's row chunks change nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.config import SIFT3DParams as JSIFT3DParams
from sift3d_tpu.features import dense as jdense

from sift3d_tpu_torch import Sift3D
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features import dense as pdense
from sift3d_tpu_torch.io import Volume
from sift3d_tpu_torch.ops import cuda_orient

from tests.conftest import make_blob_volume

torch.set_num_threads(1)

TOL = 2e-3
CASES = {
    "iso": ((24, 20, 28), 11, (1.0, 1.0, 1.0), False),
    "aniso": ((16, 24, 20), 12, (1.0, 1.3, 2.0), False),
    "rotate": ((14, 12, 16), 14, (1.0, 1.0, 1.0), True),
}


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for name, (shape, seed, units, rot) in CASES.items():
        vol = make_blob_volume(shape, seed=seed)
        out[name] = (vol, np.asarray(jdense.extract_dense_descriptors(
            jnp.asarray(vol), units, JSIFT3DParams(dense_rotate=rot))))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_dense_matches_jax(jax_out, name):
    shape, _, units, rot = CASES[name]
    vol, want = jax_out[name]
    got = pdense.extract_dense_descriptors(
        torch.as_tensor(vol), units, SIFT3DParams(dense_rotate=rot))
    assert got.dtype == torch.float32 and got.shape == (12,) + shape
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("name", ["iso", "aniso"])
def test_channel_seq_equals_default(jax_out, name, monkeypatch):
    _, _, units, _ = CASES[name]
    vol = torch.as_tensor(jax_out[name][0])
    want = pdense.extract_dense_descriptors(vol, units)
    monkeypatch.setattr(pdense, "DENSE_CHANNEL_SEQ_VOX", 1)
    got = pdense.extract_dense_descriptors(vol, units)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_rotate_row_chunks_change_nothing(jax_out, monkeypatch):
    """Orientation calls of 1000 rows and histogram chunks of 5000 window
    voxels give the same field as one call; every chunk is one
    ``orient_terms_levels`` call."""
    vol = torch.as_tensor(jax_out["rotate"][0])
    params = SIFT3DParams(dense_rotate=True)
    want = pdense.extract_dense_descriptors(vol, params=params)
    calls = []
    real = cuda_orient.orient_terms_levels

    def counted(rows, levels):
        calls.append(rows.shape[0])
        return real(rows, levels)
    monkeypatch.setattr(cuda_orient, "orient_terms_levels", counted)
    monkeypatch.setattr(pdense, "DENSE_ORIENT_ROWS", 1000)
    monkeypatch.setattr(pdense, "DENSE_HIST_VOXELS", 5000)
    got = pdense.extract_dense_descriptors(vol, params=params)
    assert calls == [1000, 1000, 688]
    assert torch.equal(got, want)


def test_rotate_orientations_default_to_identity(jax_out):
    """Rejected voxels (the flat corners among them) take R = I; accepted
    ones a rotation."""
    vol = torch.as_tensor(jax_out["rotate"][0])
    params = SIFT3DParams(dense_rotate=True)
    smooth = pdense.smooth_scale_raw_input(vol, (1.0, 1.0, 1.0), params)
    R, A6, vd = pdense.dense_orientations(smooth, (1.0, 1.0, 1.0), params)
    assert R.shape == (vol.numel(), 3, 3) and A6.dtype == torch.float64
    eye = (R == torch.eye(3)).all((1, 2))
    assert 0 < int(eye.sum()) < vol.numel()
    rot = R[~eye].double()
    np.testing.assert_allclose(torch.linalg.det(rot).numpy(), 1.0, atol=1e-4)


def test_sift3d_dense_api(jax_out):
    """``Sift3D.dense`` returns numpy float32 (12, nz, ny, nx); a Volume's
    units override the argument."""
    vol, want = jax_out["aniso"]
    _, _, units, _ = CASES["aniso"]
    s = Sift3D(device="cpu")
    got = s.dense(Volume(vol, units), units=(1.0, 1.0, 1.0))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL
    np.testing.assert_array_equal(s.dense(vol, units), got)
