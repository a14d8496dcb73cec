"""Port parity: groupwise registration (single device).

The same numpy inputs go through ``sift3d_tpu.register.groupwise`` and
``sift3d_tpu_torch.register.groupwise``. The private steps agree within
1e-12 relative (float64 on both sides); ``groupwise_solve`` on the JAX
package's replayed RANSAC draws gives the same inliers and flags and an A
within 1e-9 of its largest |A|; ``register_groupwise`` on the JAX
package's descriptors carried across gives the same matches and an A
within 1e-6; on the port's own draws and detection the affines meet the
contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.api import Sift3D as JSift3D
from sift3d_tpu.config import MatchParams as JMatchParams
from sift3d_tpu.config import RansacParams as JRansacParams
from sift3d_tpu.config import SIFT3DParams as JSIFT3DParams
from sift3d_tpu.features.descriptor import Descriptors as JDescriptors
from sift3d_tpu.register import groupwise as jgw

from sift3d_tpu_torch import pyramid as pyr
from sift3d_tpu_torch.config import (MatchParams, RansacParams,
                                     SIFT3DParams)
from sift3d_tpu_torch.convert import descriptors_from_numpy
from sift3d_tpu_torch.parallel.pipeline import batch_detect_describe
from sift3d_tpu_torch.register import groupwise as pgw
from sift3d_tpu_torch.utils.checkpoint import GroupwiseCheckpoint

from benches.data import make_volume
from tests.test_groupwise import _make_fleet, _make_group
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

REL = 1e-12
GW_SHAPE = (48, 48, 48)
GW_SHIFTS = [(0, 0, 0), (2, -1, 3), (-3, 2, 1)]       # (z, y, x)
GW_EDGES = np.array([(0, 1), (1, 2), (0, 2)])
GW_CAPS = dict(max_kp_per_level=1024)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    dev = np.abs(got - want).max() / scale
    assert dev <= rel, dev


@pytest.fixture(scope="module")
def group():
    """tests/test_groupwise.py's inputs: 4 volumes, 5 edges, 80 inliers +
    15 outliers an edge."""
    return _make_group(np.random.default_rng(42))


def _draws(params, counts):
    return torch.stack([_t(jax_draws(params, int(c))) for c in counts])


def test_edge_blocks_and_centroid_match_jax(group):
    edges, src, ref, counts, _ = group
    counts = counts.copy()
    counts[2] = 60                        # rows past count are padding
    w = (np.random.default_rng(1).random(src.shape[:2]) < 0.7).astype(
        np.float64)
    jsum, jn = jgw._point_centroid(jnp.asarray(src), jnp.asarray(ref),
                                   jnp.asarray(counts))
    psum, pn = pgw._point_centroid(_t(src), _t(ref), _t(counts))
    _close(psum, jsum)
    assert float(pn) == float(jn)
    c = np.asarray(jsum) / float(jn)
    want = [np.stack([np.asarray(b) for b in
                      jgw._edge_blocks(jnp.asarray(s - c), jnp.asarray(r - c),
                                       jnp.asarray(we))])
            for s, r, we in zip(src, ref, w)]
    got = pgw._edge_blocks(_t(src - c), _t(ref - c), _t(w))
    for k in range(3):
        _close(got[k], np.stack([x[k] for x in want]))


def test_accumulate_and_solve_match_jax(group):
    """Edges from volume 0 (i == 0) and into it (j == 0), and a repeated
    edge, with random blocks; then the reduced solve and the uncentring."""
    edges = np.concatenate([group[0], [(2, 0), (3, 1), (1, 2)]])
    rng = np.random.default_rng(2)
    E = len(edges)
    G = [rng.standard_normal((E, 4, 4)) for _ in range(3)]
    # Symmetric positive Gpp / Gqq keep the reduced system well posed.
    G[0] = G[0] @ G[0].transpose(0, 2, 1) + 4 * np.eye(4)
    G[1] = G[1] @ G[1].transpose(0, 2, 1) + 4 * np.eye(4)
    w = np.ones(E)
    jH4, jrhs = jgw._accumulate_system(jnp.asarray(edges),
                                       *map(jnp.asarray, G),
                                       jnp.asarray(w), 4)
    pH4, prhs = pgw._accumulate_system(edges, *map(_t, G), _t(w), 4)
    _close(pH4, jH4)
    _close(prhs, jrhs)
    jA = jgw._solve_reduced(jH4, jrhs, 4, 1e-9)
    pA = pgw._solve_reduced(_t(np.asarray(jH4)), _t(np.asarray(jrhs)), 4,
                            1e-9)
    _close(pA, jA)
    c = rng.standard_normal(3) * 50
    _close(pgw._uncenter(pA, _t(c)), jgw._uncenter(jA, jnp.asarray(c)))


def test_groupwise_solve_replayed_draws_match_jax(group):
    edges, src, ref, counts, _ = group
    jp = JRansacParams(num_iter=200)
    want = jgw.groupwise_solve(edges, jnp.asarray(src), jnp.asarray(ref),
                               jnp.asarray(counts), num_volumes=4,
                               ransac_params=jp)
    params = RansacParams(num_iter=200)
    got = pgw.groupwise_solve(edges, src, ref, counts, 4, params,
                              device="cpu",
                              ransac_idx=_draws(params, counts))
    np.testing.assert_array_equal(got.edge_inliers.numpy(),
                                  np.asarray(want.edge_inliers))
    np.testing.assert_array_equal(got.edge_ok.numpy(),
                                  np.asarray(want.edge_ok))
    assert bool(got.ok) == bool(want.ok)
    A = np.asarray(want.A)
    np.testing.assert_allclose(got.A.numpy(), A, rtol=0,
                               atol=1e-9 * np.abs(A).max())


def test_groupwise_solve_own_draws_recover_affines(group):
    edges, src, ref, counts, want = group
    res = pgw.groupwise_solve(edges, src, ref, counts, 4,
                              RansacParams(num_iter=200), device="cpu")
    assert bool(res.ok), res.edge_inliers
    A = res.A.numpy()
    assert A.dtype == np.float64
    np.testing.assert_array_equal(A[0], np.eye(3, 4))
    for i in range(1, 4):
        np.testing.assert_allclose(A[i][:, :3], want[i][:, :3], atol=5e-2)
        np.testing.assert_allclose(A[i][:, 3], want[i][:, 3], atol=1.0)


def test_groupwise_solve_refuses_self_edge(group):
    edges, src, ref, counts, _ = group
    bad = edges.copy()
    bad[1] = (2, 2)
    with pytest.raises(ValueError, match="self-edge"):
        pgw.groupwise_solve(bad, src, ref, counts, 4, device="cpu")


def test_groupwise_solve_empty_edge_is_not_ok(group):
    edges, src, ref, counts, _ = group
    counts = counts.copy()
    counts[3] = 0
    res = pgw.groupwise_solve(edges, src, ref, counts, 4,
                              RansacParams(num_iter=50), device="cpu")
    assert not bool(res.edge_ok[3]) and bool(res.edge_ok[[0, 1, 2, 4]].all())
    assert not bool(res.ok)


def test_singular_system_is_not_ok(group):
    """A volume that no edge reaches leaves the reduced system singular:
    JAX's solve gives non-finite affines, and so does the port's."""
    edges, src, ref, counts, _ = group
    params = RansacParams(num_iter=50)
    res = pgw.groupwise_solve(edges, src, ref, counts, 5, params,
                              ridge=0.0, device="cpu")
    want = jgw.groupwise_solve(edges, jnp.asarray(src), jnp.asarray(ref),
                               jnp.asarray(counts), num_volumes=5,
                               ransac_params=JRansacParams(num_iter=50),
                               ridge=0.0)
    assert not bool(want.ok)
    assert not bool(res.ok) and not torch.isfinite(res.A[4]).all()


def test_ransac_chunks_equal_one_call(group, monkeypatch):
    edges, src, ref, counts, _ = group
    params = RansacParams(num_iter=100)
    whole = pgw._ransac_edges(_t(src), _t(ref), _t(counts), params,
                              chunk=len(edges))
    for chunk in (1, 2, 3):
        part = pgw._ransac_edges(_t(src), _t(ref), _t(counts), params,
                                 chunk=chunk)
        assert torch.equal(part[0], whole[0])
        assert torch.equal(part[1], whole[1])
    a = pgw.groupwise_solve(edges, src, ref, counts, 4, params, device="cpu")
    # A budget of two edges' temporaries: chunks of 2, 2 and 1 edges.
    per_edge = 200 * src.shape[1] * pgw.RANSAC_ENTRY_BYTES
    monkeypatch.setattr(pgw, "RANSAC_CHUNK_BYTES", 2 * per_edge)
    assert pgw.edge_chunk(params, src.shape[1]) == 2
    b = pgw.groupwise_solve(edges, src, ref, counts, 4, params, device="cpu")
    assert torch.equal(a.A, b.A)
    assert torch.equal(a.edge_inliers, b.edge_inliers)


def test_groupwise_config5_shape_with_resume(tmp_path):
    """tests/test_groupwise.py's 64-volume fleet (127 star + loop edges)
    through the port's checkpoint store, preempted after 60 edges and
    resumed, then solved on one device."""
    edges, src, ref, counts, want = _make_fleet(np.random.default_rng(42),
                                                n_vol=64)
    ckpt = GroupwiseCheckpoint(tmp_path / "gw")

    def run_matching(kill_after=None):
        done = 0
        for e, (i, j) in enumerate(edges):
            if ckpt.has(i, j):
                continue
            ckpt.put(i, j, src[e], ref[e], counts[e])
            done += 1
            if kill_after is not None and done >= kill_after:
                return False
        return True

    assert not run_matching(kill_after=60)
    assert len(ckpt.edges()) == 60
    assert run_matching()
    assert len(ckpt.edges()) == len(edges)
    src_c, ref_c, cnt_c = ckpt.gather([tuple(e) for e in edges])
    np.testing.assert_array_equal(src_c, src)
    np.testing.assert_array_equal(cnt_c, counts)
    res = pgw.groupwise_solve(edges, src_c, ref_c, cnt_c, 64,
                              RansacParams(num_iter=60), device="cpu")
    assert bool(res.ok), res.edge_inliers
    A = res.A.numpy()
    for i in range(1, 64):
        np.testing.assert_allclose(A[i][:, :3], want[i][:, :3], atol=5e-2)
        np.testing.assert_allclose(A[i][:, 3], want[i][:, 3], atol=1.0)


# --- register_groupwise end to end: rolled copies of one volume -------------

def _volumes():
    base = make_volume(GW_SHAPE, nblob=60, seed=11)
    return np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in GW_SHIFTS])


def _want_translation(i):
    s = GW_SHIFTS[i]
    return -np.array([s[2], s[1], s[0]], np.float64)


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's descriptors of the rolled volumes (one detection
    each, padded to a common capacity and stacked, as in
    tests/test_groupwise.py), and its register_groupwise on them."""
    sift = JSift3D(JSIFT3DParams(**GW_CAPS))
    descs = [sift.extract(sift.detect(v)) for v in _volumes()]
    cap = max(d.capacity for d in descs)

    def pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, cap - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
    stacked = {f: np.stack([pad(getattr(d, f)) for d in descs])
               for f in ("xyz", "sd", "vec")}
    stacked["count"] = np.array([int(d.count) for d in descs], np.int32)
    jdesc = JDescriptors(**{k: jnp.asarray(v) for k, v in stacked.items()})
    units = (1.0, 1.0, 1.0)
    matched = jgw._match_edges(jdesc, jnp.asarray(GW_EDGES), units,
                               JMatchParams(), jnp.float32)
    res = jgw.register_groupwise(jdesc, GW_EDGES, units,
                                 ssd_dtype=jnp.float32)
    return stacked, [np.asarray(x) for x in matched], res


def test_register_groupwise_carried_descriptors_match_jax(jax_fleet):
    stacked, (jsrc, jref, jcnt), want = jax_fleet
    desc = descriptors_from_numpy(**stacked)
    src, ref, cnt = pgw._match_edges(desc, GW_EDGES, (1.0, 1.0, 1.0),
                                     pgw.MatchParams())
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(ref.numpy(), jref)
    params = RansacParams()
    got = pgw.register_groupwise(desc, GW_EDGES, (1.0, 1.0, 1.0),
                                 ransac_params=params,
                                 ransac_idx=_draws(params, jcnt))
    assert bool(want.ok) and bool(got.ok)
    np.testing.assert_array_equal(got.edge_inliers.numpy(),
                                  np.asarray(want.edge_inliers))
    np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), rtol=0,
                               atol=1e-6)


def test_register_groupwise_own_detection_recovers_shifts():
    params = SIFT3DParams(**GW_CAPS)
    plan = pyr.plan_pyramid(GW_SHAPE[::-1], (1.0, 1.0, 1.0), params)
    _, desc, overflow = batch_detect_describe(_volumes(), plan, params,
                                              device="cpu")
    assert not overflow.any()
    res = pgw.register_groupwise(desc, GW_EDGES, (1.0, 1.0, 1.0))
    assert bool(res.ok), res.edge_inliers
    A = res.A.numpy()
    for i in range(len(GW_SHIFTS)):
        np.testing.assert_allclose(A[i][:, :3], np.eye(3), atol=5e-2)
        np.testing.assert_allclose(A[i][:, 3], _want_translation(i), atol=5.0)


def test_register_groupwise_refuses_other_ssd_dtype(jax_fleet):
    """float64 is accepted (it once raised): on this well-separated fleet
    it gives float32's matches, flags and affines."""
    desc = descriptors_from_numpy(**jax_fleet[0])
    units = (1.0, 1.0, 1.0)
    m32, m64 = (pgw._match_edges(desc, GW_EDGES, units, MatchParams(), dt)
                for dt in (torch.float32, torch.float64))
    for a, b in zip(m32, m64):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    params = RansacParams()
    draws = _draws(params, m32[2].numpy())
    r32, r64 = (pgw.register_groupwise(desc, GW_EDGES, units,
                                       ransac_params=params, ssd_dtype=dt,
                                       ransac_idx=draws)
                for dt in (torch.float32, torch.float64))
    assert bool(r64.ok) and bool(r32.ok)
    np.testing.assert_array_equal(r64.edge_ok.numpy(), r32.edge_ok.numpy())
    np.testing.assert_array_equal(r64.edge_inliers.numpy(),
                                  r32.edge_inliers.numpy())
    np.testing.assert_array_equal(r64.A.numpy(), r32.A.numpy())
