"""Port parity: the matchers' SSD precision (``ssd_dtype``, ``dtype``).

``api.match_descriptors``, ``register.pipeline.register_pair``,
``register.groupwise.register_groupwise`` and its sharded form take the
SSD's dtype, as the JAX package's do, and so do the sharded matchers
``parallel.nn_match_sharded`` and ``nn_match_ring`` (``dtype``, at JAX's
position; here at world size 1 against JAX's on a one-device mesh). The
descriptor sets below hold one decisive query: its SSDs to its best and
second target are integers (exact in fp32 and float64), and ``nn_thresh``
is chosen so that the float64 ratio lies 4e-10 above nn_thresh^2
(rejected) while fp32, whose nn_thresh^2 rounds up, accepts it. float64
must then reject that row, as the JAX package under x64 and a numpy
float64 ratio test do, and float32 must match it, as the JAX package's
float32 does. The sets are ``chip_smoke.decisive_sets``, which the card
check runs through the same matchers.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sift3d_tpu.api import match_descriptors as jmatch_descriptors
from sift3d_tpu.config import MatchParams as JMatchParams
from sift3d_tpu.config import RansacParams as JRansacParams
from sift3d_tpu.features.descriptor import Descriptors as JDescriptors
from sift3d_tpu.parallel import make_mesh as jmake_mesh
from sift3d_tpu.parallel import shard_match as jshard
from sift3d_tpu.register import groupwise as jgw
from sift3d_tpu.register.pipeline import register_pair as jregister_pair

from sift3d_tpu_torch.api import match_descriptors
from sift3d_tpu_torch.config import MatchParams, RansacParams
from sift3d_tpu_torch.convert import descriptors_from_numpy
from sift3d_tpu_torch.parallel import make_mesh
from sift3d_tpu_torch.parallel import shard_match as pshard
from sift3d_tpu_torch.register import groupwise as pgw
from sift3d_tpu_torch.register.pipeline import register_pair

from chip_smoke import DECISIVE_GOOD, DECISIVE_SHIFT, decisive_sets
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

N_GOOD = DECISIVE_GOOD
SHIFT = DECISIVE_SHIFT                 # src = ref + SHIFT (x, y, z)
UNITS = (1.0, 1.0, 1.0)


def _numpy_match(d1, d2, t):
    """The ratio test with forward-backward consistency in float64, on
    SSDs summed from differences (reference sift.c:2840-2969)."""
    D = ((d1[:, None, :].astype(np.float64) -
          d2[None, :, :].astype(np.float64)) ** 2).sum(-1)

    def one_way(D):
        idx = np.argmin(D, axis=1)
        srt = np.sort(D, axis=1)
        return idx, ~(srt[:, 0] > (t * t) * srt[:, 1])
    fi, fok = one_way(D)
    bi, bok = one_way(D.T)
    keep = fok & (bi[fi] == np.arange(len(d1))) & bok[fi]
    return np.where(keep, fi, -1).astype(np.int32)


def _port(d, cap=None):
    n = len(d["vec"])
    cap = cap or n
    pad = [(0, cap - n)]
    return descriptors_from_numpy(
        xyz=np.pad(d["xyz"], pad + [(0, 0)]), sd=np.zeros(cap),
        vec=np.pad(d["vec"], pad + [(0, 0)]), count=n)


def _jax(d):
    return JDescriptors(xyz=jnp.asarray(d["xyz"]),
                        sd=jnp.zeros(len(d["vec"])),
                        vec=jnp.asarray(d["vec"]),
                        count=jnp.int32(len(d["vec"])))


@pytest.fixture(scope="module")
def sets():
    src, ref, t = decisive_sets()
    want64 = _numpy_match(src["vec"], ref["vec"], t)
    assert want64[N_GOOD] == -1
    np.testing.assert_array_equal(want64[:N_GOOD], np.arange(N_GOOD))
    return src, ref, t, want64


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_match_descriptors_ssd_dtype(sets, dtype):
    src, ref, t, want64 = sets
    with jax.enable_x64(True):
        want = np.asarray(jmatch_descriptors(_jax(src), _jax(ref), t,
                                             ssd_dtype=getattr(jnp, dtype)))
    got = match_descriptors(_port(src), _port(ref), t,
                            ssd_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got, want)
    if dtype == "float64":
        np.testing.assert_array_equal(got, want64)
    else:
        # fp32 accepts the decisive row: the argument is not dropped.
        assert got[N_GOOD] == N_GOOD
        np.testing.assert_array_equal(got[:N_GOOD], want64[:N_GOOD])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_register_pair_ssd_dtype(sets, dtype):
    src, ref, t, want64 = sets
    with jax.enable_x64(True):
        jres = jregister_pair(_jax(src), _jax(ref), UNITS, UNITS,
                              JMatchParams(nn_thresh=t), JRansacParams(),
                              ssd_dtype=getattr(jnp, dtype))
        jmatches = np.asarray(jres.matches)
    res = register_pair(_port(src), _port(ref), UNITS, UNITS,
                        MatchParams(nn_thresh=t), RansacParams(),
                        ssd_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(res.matches.numpy(), jmatches)
    assert res.num_matches == int(jres.num_matches) == \
        N_GOOD + (dtype == "float32")
    if dtype == "float64":
        np.testing.assert_array_equal(res.matches.numpy(), want64)
    assert res.ok and bool(jres.ok)
    for A in (res.A.numpy(), np.asarray(jres.A)):
        np.testing.assert_allclose(A[:, :3], np.eye(3), atol=5e-2)
        np.testing.assert_allclose(A[:, 3], SHIFT, atol=5.0)


def _fleet(src, ref):
    """Two volumes (src, ref) stacked at one capacity, one edge."""
    cap = len(ref["vec"])

    def stack(f):
        return np.stack([np.pad(d[f], [(0, cap - len(d[f])), (0, 0)])
                         for d in (src, ref)])
    return dict(xyz=stack("xyz"), vec=stack("vec"), sd=np.zeros((2, cap)),
                count=np.array([len(src["vec"]), cap], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_register_groupwise_ssd_dtype(sets, dtype):
    src, ref, t, _ = sets
    fleet = _fleet(src, ref)
    edges = np.array([(0, 1)])
    with jax.enable_x64(True):
        jdesc = JDescriptors(**{k: jnp.asarray(v) for k, v in fleet.items()})
        jcnt = jgw._match_edges(jdesc, jnp.asarray(edges), UNITS,
                                JMatchParams(nn_thresh=t),
                                getattr(jnp, dtype))[2]
        want = jgw.register_groupwise(jdesc, edges, UNITS,
                                      JMatchParams(nn_thresh=t),
                                      ssd_dtype=getattr(jnp, dtype))
        params = RansacParams()
        draws = torch.stack([torch.as_tensor(jax_draws(params, int(c)))
                             for c in np.asarray(jcnt)])
    desc = descriptors_from_numpy(**fleet)
    mp = MatchParams(nn_thresh=t)
    cnt = pgw._match_edges(desc, edges, UNITS, mp, getattr(torch, dtype))[2]
    assert int(cnt[0]) == int(jcnt[0]) == N_GOOD + (dtype == "float32")
    got = pgw.register_groupwise(desc, edges, UNITS, mp, params,
                                 ssd_dtype=getattr(torch, dtype),
                                 ransac_idx=draws)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.edge_inliers.numpy(),
                                  np.asarray(want.edge_inliers))
    np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), rtol=0,
                               atol=1e-6)


def test_register_groupwise_sharded_float64_at_world_one(sets):
    """The sharded form takes float64 too, and at world size 1 equals the
    one-device call on the same draws."""
    src, ref, t, _ = sets
    desc = descriptors_from_numpy(**_fleet(src, ref))
    edges = np.array([(0, 1)])
    mp = MatchParams(nn_thresh=t)
    params = RansacParams()
    draws = torch.as_tensor(jax_draws(params, N_GOOD))[None]
    want = pgw.register_groupwise(desc, edges, UNITS, mp, params,
                                  ssd_dtype=torch.float64, ransac_idx=draws)
    m = make_mesh(device="cpu")
    try:
        got = pgw.register_groupwise_sharded(
            desc, edges, UNITS, m, match_params=mp, ransac_params=params,
            ssd_dtype=torch.float64, ransac_idx=draws, device="cpu")
    finally:
        dist.destroy_process_group()
    assert bool(got.ok) and bool(want.ok)
    assert int(got.edge_inliers[0]) == int(want.edge_inliers[0]) == N_GOOD
    np.testing.assert_allclose(got.A.numpy(), want.A.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("name", ["nn_match_sharded", "nn_match_ring"])
def test_sharded_matchers_take_dtype_at_jax_position(name):
    """Both packages' sharded matchers name their arguments alike, in the
    same order, so a positional call binds the same: the eighth argument
    is ``dtype``."""
    fns = (getattr(jshard, name), getattr(pshard, name))
    names = [list(inspect.signature(f).parameters) for f in fns]
    assert names[1] == names[0]
    for f in fns:
        bound = inspect.signature(f).bind(*range(8)).arguments
        assert list(bound)[7] == "dtype", (f, list(bound))


@pytest.mark.parametrize("name", ["nn_match_sharded", "nn_match_ring"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_matchers_dtype_at_world_one(sets, name, dtype):
    """At world size 1 (a one-rank gloo mesh) the port's sharded matchers
    equal JAX's on a one-device mesh under x64, in each dtype; float64
    rejects the decisive row that float32 accepts. The dense branch of
    ``nn_match_sharded`` (the streamed one is fp32 in both packages)."""
    src, ref, t, want64 = sets
    kw = {"streamed": False} if name == "nn_match_sharded" else {}
    with jax.enable_x64(True):
        jmesh = jmake_mesh(jax.devices()[:1], data=1, space=1)
        f = jax.jit(lambda a, b: getattr(jshard, name)(
            a, b, t, jmesh, dtype=getattr(jnp, dtype), **kw))
        want = np.asarray(f(jnp.asarray(src["vec"]), jnp.asarray(ref["vec"])))
    fn = getattr(pshard, name)
    d1, d2 = torch.as_tensor(src["vec"]), torch.as_tensor(ref["vec"])
    tdt = getattr(torch, dtype)
    m = make_mesh(device="cpu")
    try:
        got = fn(d1, d2, t, m, dtype=tdt, **kw).numpy()
        positional = fn(d1, d2, t, m, "space", None, None, tdt).numpy()
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(positional, got)
    if dtype == "float64":
        np.testing.assert_array_equal(got, want64)
    else:
        assert got[N_GOOD] == N_GOOD
        np.testing.assert_array_equal(got[:N_GOOD], want64[:N_GOOD])
