"""Port parity: descriptors.

The JAX package's own keypoints (carried across with
``sift3d_tpu_torch.convert``) go through the port's descriptor stage on
the CPU, where ``descrip_window`` runs its plain PyTorch version. Held to
the 2e-3 descriptor contract against both JAX formulations: the eager
window path (``use_pallas=False``) and the Pallas kernel in interpret
mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features import descriptor as jdesc
from sift3d_tpu.features.detect import detect_keypoints, kp_levels
from sift3d_tpu.features.keypoints import head

from sift3d_tpu_torch import Sift3D
from sift3d_tpu_torch.features import descriptor as tdesc
from sift3d_tpu_torch.features.keypoints import head as thead

from benches.data import make_volume
from tests.torch_helpers import jax_keypoints_to_port

torch.set_num_threads(1)

TOL = 2e-3
UNITS = (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def jax_side():
    vol = make_volume((40, 40, 40), nblob=50, seed=3)
    kp, gpyr, plan = detect_keypoints(vol, UNITS, JParams())
    n = int(kp.count)
    assert n >= 10, "too few keypoints to be a real test"
    kp = head(kp, n)
    return vol, kp, gpyr, plan


def _buckets(kp, plan):
    """{(o, s): (centers (n, 3) f32, R (n, 3, 3) f32)} of a JAX kp set."""
    o, s = np.asarray(kp.o), np.asarray(kp.s)
    zyx = np.stack([np.asarray(kp.z), np.asarray(kp.y), np.asarray(kp.x)],
                   -1).astype(np.float32)
    R = np.asarray(kp.R)
    out = {}
    for lv in kp_levels(plan):
        sel = (o == lv[0]) & (s == lv[1])
        if sel.any():
            out[lv] = (zyx[sel], R[sel])
    return out


def _port_level(gpyr, plan, lv, centers, R, count=None):
    geom = plan.gpyr_level(*lv)
    return tdesc.extract_level(
        torch.as_tensor(np.array(gpyr[lv])), torch.as_tensor(centers),
        torch.as_tensor(R), geom.scale, plan.octave_units(lv[0]),
        count=count).numpy()


def test_levels_match_eager_jax(jax_side):
    _, kp, gpyr, plan = jax_side
    buckets = _buckets(kp, plan)
    assert len(buckets) >= 2
    for lv, (centers, R) in buckets.items():
        geom = plan.gpyr_level(*lv)
        want = np.asarray(jdesc.extract_level(
            gpyr[lv], jnp.asarray(centers), jnp.asarray(R), geom.scale,
            plan.octave_units(lv[0]), use_pallas=False))
        got = _port_level(gpyr, plan, lv, centers, R)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"level {lv}")
        assert np.abs(got).sum() > 0


def test_levels_match_pallas_interpret(jax_side):
    """The Pallas window kernel in interpret mode, on the first rows of the
    two fullest levels (interpretation is slow)."""
    _, kp, gpyr, plan = jax_side
    buckets = _buckets(kp, plan)
    fullest = sorted(buckets, key=lambda lv: -len(buckets[lv][0]))[:2]
    for lv in fullest:
        centers, R = buckets[lv][0][:3], buckets[lv][1][:3]
        geom = plan.gpyr_level(*lv)
        want = np.asarray(jdesc.extract_level(
            gpyr[lv], jnp.asarray(centers), jnp.asarray(R), geom.scale,
            plan.octave_units(lv[0]), interpret=True))
        got = _port_level(gpyr, plan, lv, centers, R)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"level {lv}")


def test_rows_past_count_are_zero(jax_side):
    _, kp, gpyr, plan = jax_side
    buckets = _buckets(kp, plan)
    lv = max(buckets, key=lambda k: len(buckets[k][0]))
    centers, R = buckets[lv]
    assert len(centers) >= 3
    full = _port_level(gpyr, plan, lv, centers, R)
    part = _port_level(gpyr, plan, lv, centers, R, count=2)
    np.testing.assert_array_equal(part[2:], 0.0)
    np.testing.assert_array_equal(part[:2], full[:2])


def test_extract_descriptors_whole_volume(jax_side):
    """The port's own pyramid, keypoints and level buckets against the JAX
    package's extract_descriptors on the same volume."""
    vol, kp, gpyr, plan = jax_side
    caps = {lv: len(v[0]) for lv, v in _buckets(kp, plan).items()}
    want = jdesc.extract_descriptors(gpyr, kp, plan, JParams(), chunk=8,
                                     level_caps={lv: caps.get(lv, 0)
                                                 for lv in kp_levels(plan)})
    s3d = Sift3D(device="cpu")
    tkp, got = s3d.detect_and_extract(vol, UNITS)
    n = int(want.count)
    assert got.count == n == tkp.count
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz)[:n])
    np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec)[:n],
                               rtol=0, atol=TOL)


def test_descrip_work_counts_window_union():
    """The byte count reads the union of the rows' windows once: a repeated
    row adds its inputs (volume index, start, centre, R) and its output,
    not its window again."""
    from sift3d_tpu_torch.ops.cuda_window import descrip_work
    level = torch.zeros((20, 20, 20))
    centers = torch.full((2, 3), 10.0)
    R = torch.eye(3).expand(2, 3, 3)
    args = ((3, 3, 3), (8, 8, 8), UNITS, 1.0, 4.0)
    b1, o1, *_ = descrip_work(level, centers[:1], R[:1], 1, *args)
    b2, o2, *_ = descrip_work(level, centers, R, 2, *args)
    window, row = 4 * 10 ** 3, 4 * (1 + 3 + 3 + 9) + 4 * 768
    assert (b1, b2) == (window + row, window + 2 * row)
    assert o2 == 2 * o1 > 0


def test_descrip_work_shared_masks_read_a_tensor_once():
    """Calls that share ``masks`` read one tensor's windows once (the
    raw-image path's buckets all read one smoothed image); a copy of the
    tensor is another read."""
    from sift3d_tpu_torch.ops.cuda_window import descrip_work
    level = torch.zeros((20, 20, 20))
    centers = torch.full((1, 3), 10.0)
    R = torch.eye(3)[None]
    args = ((3, 3, 3), (8, 8, 8), UNITS, 1.0, 4.0)
    masks = {}
    first = descrip_work(level, centers, R, 1, *args, masks=masks)
    again = descrip_work(level, centers, R, 1, *args, masks=masks)
    copy = descrip_work(level.clone(), centers, R, 1, *args, masks=masks)
    window, row = 4 * 10 ** 3, 4 * (1 + 3 + 3 + 9) + 4 * 768
    assert first[0] == copy[0] == window + row
    assert again[0] == row
    assert again[1:] == first[1:] == copy[1:]


def test_jax_keypoints_carry_across(jax_side):
    """convert.keypoints_from_numpy keeps every field and the count, and
    head() keeps the first rows of both packages' sets alike."""
    _, kp, _, _ = jax_side
    tkp = jax_keypoints_to_port(kp)
    assert tkp.count == int(kp.count)
    np.testing.assert_array_equal(tkp.to_numpy(), kp.to_numpy())
    np.testing.assert_array_equal(tkp.s.numpy(), np.asarray(kp.s))
    np.testing.assert_array_equal(thead(tkp, 4).to_numpy(),
                                  head(kp, 4).to_numpy())
