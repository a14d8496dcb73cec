"""Port parity: groupwise registration with the edges split over a mesh.

Inputs: ``tests/test_groupwise.py``'s 4-volume group of 5 edges and its
64-volume config-5-shaped fleet; for ``register_groupwise_sharded``, the
three rolled 48^3 volumes of ``tests/test_torch_groupwise.py`` (the 24^3
volumes of ``test_groupwise.py`` hold 0-3 keypoints each and give no
solvable system), described by the port and handed to both packages as
numpy. They go through the JAX package's ``groupwise_solve_sharded`` and
``register_groupwise_sharded``, jitted on the virtual CPU mesh, and
through the port's in one 4-rank gloo world (``tests/torch_parallel_worker``,
120 s timeout: past it the ranks are killed and every case fails) at the
meshes (1, 4), (2, 2) and (4, 1), so the edges split over 1, 2 and 4 data
ranks (3 or 5 edges: padded). The port replays the JAX package's RANSAC
draws: inliers and flags equal, A within 2e-4 of JAX's sharded result
(its own test's bound) and within 1e-9 of its largest |A| of the port's
one-device solve on the same draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift3d_tpu.config import MatchParams as JMatchParams
from sift3d_tpu.config import RansacParams as JRansacParams
from sift3d_tpu.features.descriptor import Descriptors as JDescriptors
from sift3d_tpu.parallel import make_mesh as jmake_mesh
from sift3d_tpu.register import groupwise as jgw

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import RansacParams, SIFT3DParams
from sift3d_tpu_torch.convert import descriptors_from_numpy
from sift3d_tpu_torch.parallel.pipeline import batch_detect_describe
from sift3d_tpu_torch.register import groupwise as pgw

from tests import torch_parallel_worker as worker
from tests.test_groupwise import _make_fleet, _make_group
from tests.test_torch_groupwise import GW_CAPS, GW_EDGES, GW_SHAPE, _volumes
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

UNITS = (1.0, 1.0, 1.0)
REG_EDGES = GW_EDGES
FLEET_ITERS = 60


def _draws(params, counts):
    return np.stack([jax_draws(params, int(c)) for c in counts])


def make_inputs() -> dict:
    inp = {}
    edges, src, ref, counts, _ = _make_group(np.random.default_rng(42))
    inp.update({"gw_solve/edges": edges, "gw_solve/src": src,
                "gw_solve/ref": ref, "gw_solve/counts": counts,
                "gw_solve/idx": _draws(RansacParams(
                    num_iter=worker.GW_SOLVE_ITERS), counts)})
    params = SIFT3DParams(**GW_CAPS)
    vols = _volumes()
    plan = tpyr.plan_pyramid(GW_SHAPE[::-1], UNITS, params)
    _, desc, _ = batch_detect_describe(vols, plan, params, device="cpu")
    for f in ("xyz", "sd", "vec", "count"):
        inp[f"gw_register/{f}"] = getattr(desc, f).numpy()
    inp["gw_register/edges"] = REG_EDGES
    edges, src, ref, counts, want = _make_fleet(np.random.default_rng(42),
                                                n_vol=64)
    inp.update({"gw_fleet/edges": edges, "gw_fleet/src": src,
                "gw_fleet/ref": ref, "gw_fleet/counts": counts,
                "gw_fleet/n": np.asarray(64), "gw_fleet/want": want,
                "gw_fleet/idx": _draws(RansacParams(num_iter=FLEET_ITERS),
                                       counts)})
    return inp


def _jdesc(inp):
    return JDescriptors(**{f: jnp.asarray(inp[f"gw_register/{f}"])
                           for f in ("xyz", "sd", "vec", "count")})


def register_draws(inp):
    """The JAX package's hypothesis draws for the edges of
    ``register_groupwise``: from its own match counts."""
    _, _, cnt = jgw._match_edges(_jdesc(inp), jnp.asarray(REG_EDGES), UNITS,
                                 JMatchParams(), jnp.float32)
    return _draws(RansacParams(num_iter=worker.GW_REGISTER_ITERS),
                  np.asarray(cnt))


def jax_results(inp) -> dict:
    out = {}
    for name, n_vol, iters, data in (
            ("gw_solve", 4, worker.GW_SOLVE_ITERS, 4),
            ("gw_fleet", 64, FLEET_ITERS, 4)):
        edges = inp[f"{name}/edges"]
        mesh = jmake_mesh(jax.devices()[:data], data=data, space=1)
        f = jax.jit(lambda s, r, c, e=edges, n=n_vol, i=iters, m=mesh:
                    jgw.groupwise_solve_sharded(
                        e, s, r, c, num_volumes=n, mesh=m,
                        ransac_params=JRansacParams(num_iter=i)))
        res = f(*(jnp.asarray(inp[f"{name}/{k}"])
                  for k in ("src", "ref", "counts")))
        out[name] = res
    mesh = jmake_mesh(jax.devices()[:2], data=2, space=1)
    f = jax.jit(lambda d: jgw.register_groupwise_sharded(
        d, REG_EDGES, UNITS, mesh,
        ransac_params=JRansacParams(num_iter=worker.GW_REGISTER_ITERS)))
    out["gw_register"] = f(_jdesc(inp))
    return {name: {"A": np.asarray(r.A),
                   "inliers": np.asarray(r.edge_inliers),
                   "edge_ok": np.asarray(r.edge_ok), "ok": bool(r.ok)}
            for name, r in out.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("groupwise_world")
    inp = make_inputs()
    inp["gw_register/idx"] = register_draws(inp)
    np.savez(d / "inputs.npz", **inp)
    import threading
    box = {}
    t = threading.Thread(target=lambda: box.update(zip(
        ("results", "errors", "failure"),
        worker.run_world("groupwise", d / "inputs.npz", d))))
    t.start()
    try:
        jax_out = jax_results(inp)
    finally:
        t.join()
    return inp, jax_out, box["results"], box["errors"], box["failure"]


def _one_device(inp, case):
    """The port's one-device result on the same draws."""
    if case == "gw_register":
        desc = descriptors_from_numpy(*(inp[f"gw_register/{f}"] for f in
                                        ("xyz", "sd", "vec", "count")))
        return pgw.register_groupwise(
            desc, REG_EDGES, UNITS,
            ransac_params=RansacParams(num_iter=worker.GW_REGISTER_ITERS),
            ransac_idx=torch.as_tensor(inp["gw_register/idx"]))
    iters = worker.GW_SOLVE_ITERS if case == "gw_solve" else FLEET_ITERS
    n_vol = 4 if case == "gw_solve" else 64
    return pgw.groupwise_solve(
        inp[f"{case}/edges"], inp[f"{case}/src"], inp[f"{case}/ref"],
        inp[f"{case}/counts"], n_vol, RansacParams(num_iter=iters),
        device="cpu", ransac_idx=torch.as_tensor(inp[f"{case}/idx"]))


@pytest.mark.parametrize("case,mesh", worker.cases("groupwise"))
def test_groupwise_sharded(world, case, mesh):
    inp, jax_out, results, errors, failure = world
    assert not failure, failure
    key = f"{case}/{mesh}"
    assert key not in errors, errors[key]
    got = {k: results[f"{key}/{k}"] for k in ("A", "inliers", "edge_ok",
                                               "ok")}
    want = jax_out[case]
    assert bool(got["ok"]) and want["ok"]
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_array_equal(got["edge_ok"], want["edge_ok"])
    np.testing.assert_allclose(got["A"], want["A"], rtol=0, atol=2e-4)
    one = _one_device(inp, case)
    np.testing.assert_array_equal(got["inliers"], one.edge_inliers.numpy())
    np.testing.assert_array_equal(got["edge_ok"], one.edge_ok.numpy())
    A1 = one.A.numpy()
    np.testing.assert_allclose(got["A"], A1, rtol=0,
                               atol=1e-9 * np.abs(A1).max())
    np.testing.assert_array_equal(got["A"][0], np.eye(3, 4))
    if case == "gw_fleet":
        truth = inp["gw_fleet/want"]
        for i in range(1, 64):
            np.testing.assert_allclose(got["A"][i][:, :3], truth[i][:, :3],
                                       atol=5e-2)
            np.testing.assert_allclose(got["A"][i][:, 3], truth[i][:, 3],
                                       atol=1.0)
