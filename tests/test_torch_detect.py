"""Port parity: keypoint detection (pyramid -> extrema -> orientation).

Rows (x, y, z, o, s, sd) must equal the JAX package's exactly and R
within 1e-5 - the row-exact standard the JAX package is held to against
the C reference.
"""

import numpy as np
import pytest
import torch

from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features.detect import detect_keypoints

from sift3d_tpu_torch import Sift3D

from tests.conftest import make_blob_volume
from tests.torch_helpers import keypoint_rows, port_params

torch.set_num_threads(1)

CASES = {
    "iso32": ((32, 32, 32), (1.0, 1.0, 1.0), 7, JParams()),
    "aniso": ((24, 32, 40), (1.0, 1.25, 2.0), 5, JParams()),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def detected(request):
    shape, units, seed, jparams = CASES[request.param]
    vol = make_blob_volume(shape, seed=seed)
    jkp, _, _ = detect_keypoints(vol, units, jparams)
    s3d = Sift3D(port_params(jparams), device="cpu")
    tkp = s3d.detect(vol, units)
    return request.param, keypoint_rows(jkp), keypoint_rows(tkp), s3d


def test_keypoint_rows_exact(detected):
    name, want, got, _ = detected
    assert want.shape[0] >= 3, "too few keypoints to be a real test"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :6], want[:, :6])
    np.testing.assert_allclose(got[:, 6:], want[:, 6:], rtol=0, atol=1e-5)


def test_no_overflow_at_default_caps(detected):
    assert not detected[3].kp_overflow


def test_level_caps_keep_scan_order_prefix():
    """Capacities below the extrema counts keep, on every level, the
    keypoints of the first ``cap`` extrema in scan order - a prefix of the
    uncapped level's rows - and report the loss as kp_overflow."""
    shape, units, seed, _ = CASES["iso32"]
    vol = make_blob_volume(shape, seed=seed)
    full = Sift3D(device="cpu")
    rows = keypoint_rows(full.detect(vol, units))
    capped = Sift3D(port_params(JParams(max_kp_per_level=3,
                                        max_kp_per_octave=(2, 1))),
                    device="cpu")
    crows = keypoint_rows(capped.detect(vol, units))
    assert capped.kp_overflow and not full.kp_overflow
    assert 0 < crows.shape[0] < rows.shape[0]
    for o, s in {(int(r[3]), int(r[4])) for r in rows}:
        lv = rows[(rows[:, 3] == o) & (rows[:, 4] == s)]
        clv = crows[(crows[:, 3] == o) & (crows[:, 4] == s)]
        assert clv.shape[0] <= (2 if o == 0 else 1)
        np.testing.assert_array_equal(clv, lv[:clv.shape[0]])


def test_rotations_orthonormal(detected):
    _, _, got, _ = detected
    R = got[:, 6:].reshape(-1, 3, 3)
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-3
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-3)
