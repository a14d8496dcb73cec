"""Port parity: host plan tables, Gaussian/DoG pyramid and DoG extrema.

The same numpy volume goes through ``sift3d_tpu`` (JAX, CPU) and
``sift3d_tpu_torch`` (plain PyTorch, CPU). Host tables must be
array-equal, pyramid levels within 1e-5 (fp32 matmuls summed in another
order), extrema rows exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features import detect as jdetect
from sift3d_tpu.ops import conv as jconv
from sift3d_tpu.ops import gauss as jgauss
from sift3d_tpu.ops import geometry as jgeom

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features import detect as tdetect
from sift3d_tpu_torch.ops import conv as tconv
from sift3d_tpu_torch.ops import gauss as tgauss
from sift3d_tpu_torch.ops import geometry as tgeom

from tests.conftest import make_blob_volume
from tests.torch_helpers import port_params

torch.set_num_threads(1)

CASES = {
    "iso32": ((32, 32, 32), (1.0, 1.0, 1.0), 7),
    "aniso": ((24, 32, 40), (1.0, 1.25, 2.0), 5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pyramids(request):
    shape, units, seed = CASES[request.param]
    vol = make_blob_volume(shape, seed=seed)
    nz, ny, nx = shape
    jplan = jpyr.plan_pyramid((nx, ny, nz), units, JParams())
    jg = jpyr.build_gpyr(jpyr.im_scale(jnp.asarray(vol)), jplan)
    jd = jpyr.build_dog(jg, jplan)
    jext = jdetect.detect_extrema_levels(jd, jplan, JParams())
    tplan = tpyr.plan_pyramid((nx, ny, nz), units, SIFT3DParams())
    tg = tpyr.build_gpyr(tpyr.im_scale(torch.as_tensor(vol)), tplan)
    td = tpyr.build_dog(tg, tplan)
    text = tdetect.detect_extrema_levels(td, tplan, SIFT3DParams())
    return dict(jplan=jplan, tplan=tplan, jg=jg, tg=tg, jd=jd, td=td,
                jext=jext, text=text)


@pytest.mark.parametrize("sigma", [0.5, 1.2, 1.6, 2.9])
def test_gauss_taps_equal(sigma):
    np.testing.assert_array_equal(tgauss.gauss_taps(sigma),
                                  jgauss.gauss_taps(sigma))


@pytest.mark.parametrize("n,unit_dim", [(8, 1.0), (33, 1.0), (40, 2.0),
                                        (64, 0.8)])
def test_conv_matrix_equal(n, unit_dim):
    taps = jgauss.gauss_taps(1.6)
    np.testing.assert_array_equal(
        tconv.conv_matrix(taps, 1.0, unit_dim, n),
        jconv.conv_matrix(taps, 1.0, unit_dim, n))


def test_face_tables_equal():
    for a, b in zip(tgeom.icosahedron(), jgeom.icosahedron()):
        np.testing.assert_array_equal(a, b)
    jt, tt = jgeom.face_tables(), tgeom.face_tables()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    for a, b in zip(tgeom.face_solve_tables(), jgeom.face_solve_tables()):
        np.testing.assert_array_equal(a, b)


def test_plan_equal(pyramids):
    jplan, tplan = pyramids["jplan"], pyramids["tplan"]
    jd = dataclasses.asdict(jplan)
    td = dataclasses.asdict(tplan)
    # The port's params lack the JAX-only fields; compare them carried across.
    jd["params"] = dataclasses.asdict(port_params(jplan.params))
    assert jd == td
    for o in range(jplan.num_octaves):
        for s in range(jplan.first_level, jplan.last_gpyr_level + 1):
            assert dataclasses.asdict(jplan.gpyr_level(o, s)) == \
                dataclasses.asdict(tplan.gpyr_level(o, s))
    assert jplan.downsample_level == tplan.downsample_level


def test_gpyr_and_dog_levels(pyramids):
    for name in ("g", "d"):
        jl, tl = pyramids["j" + name], pyramids["t" + name]
        assert sorted(jl) == sorted(tl)
        for key in jl:
            want = np.asarray(jl[key])
            got = tl[key].numpy()
            assert got.shape == want.shape, key
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=f"{name} level {key}")


def test_extrema_exact(pyramids):
    jext, text = pyramids["jext"], pyramids["text"]
    assert sorted(jext) == sorted(text)
    n_total = 0
    for key in jext:
        jzyx, jcount, jtotal = jext[key]
        tzyx, tcount, ttotal = text[key]
        assert (tcount, ttotal) == (int(jcount), int(jtotal)), key
        np.testing.assert_array_equal(tzyx.numpy(),
                                      np.asarray(jzyx)[:int(jcount)])
        n_total += tcount
    assert n_total > 5, "too few extrema to be a real test"


def test_extrema_capacity_truncates_in_scan_order(pyramids):
    """At a capacity below the extrema total, both packages keep the first
    rows in scan order and report the unclamped total."""
    from sift3d_tpu.features.extrema import level_extrema as jlevel
    from sift3d_tpu_torch.features.extrema import level_extrema as tlevel
    key = max(pyramids["text"], key=lambda k: pyramids["text"][k][1])
    o, s = key
    jd, td = pyramids["jd"], pyramids["td"]
    jzyx, jcount, jtotal = jlevel(jd[(o, s - 1)], jd[(o, s)], jd[(o, s + 1)],
                                  0.1, 2)
    tzyx, tcount, ttotal = tlevel(td[(o, s - 1)], td[(o, s)], td[(o, s + 1)],
                                  0.1, 2)
    assert ttotal > 2 and (tcount, ttotal) == (int(jcount), int(jtotal))
    np.testing.assert_array_equal(tzyx.numpy(), np.asarray(jzyx))
