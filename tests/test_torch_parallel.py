"""Port parity: the mesh-sharded paths (``sift3d_tpu_torch/parallel``).

The same numpy inputs (``tests/test_parallel.py``, ``test_shard_windows.py``,
``test_tps_shard_match.py`` and ``test_pyramid_pipelined.py``'s, with
batches of 4 so that 4 data ranks split them) go through the JAX
package's sharded functions, jitted on the virtual 8-device CPU mesh, and
through the port's in one 4-rank gloo world (``tests/torch_parallel_worker``,
120 s timeout: past it the ranks are killed and every case fails) at the
meshes (1, 4), (2, 2) and (4, 1). Each case at each mesh is one test,
held to JAX's sharded result and to the port's unsharded path: conv
within 2e-6 (2e-5 sharded along y or x), extrema rows and counts exact,
orientation ``valid`` exact and R within 2e-4, descriptors within 2e-4
(1e-5 for the batched pipeline rows), matches exact, pipelined levels
within 2e-6 of sequential, overflow flags equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import SIFT3DParams as JParams
from sift3d_tpu.features.match import nn_match as jnn_match
from sift3d_tpu.ops.gauss import gauss_taps
from sift3d_tpu.parallel import (conv_sep_sharded as jconv_sharded,
                                 factor_devices as jfactor_devices,
                                 level_extrema_sharded as jextrema_sharded,
                                 make_mesh as jmake_mesh)
from sift3d_tpu.parallel import pipeline as jpipe
from sift3d_tpu.parallel import shard_match as jmatch
from sift3d_tpu.parallel import shard_windows as jwin

from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.features.descriptor import extract_level
from sift3d_tpu_torch.features.extrema import level_extrema
from sift3d_tpu_torch.features.match import nn_match
from sift3d_tpu_torch.features.orientation import assign_orientations_level
from sift3d_tpu_torch.ops import conv as tconv
from sift3d_tpu_torch.parallel import factor_devices
from sift3d_tpu_torch.parallel import pipeline as tpipe

from tests import torch_parallel_worker as worker
from tests.conftest import make_blob_volume

torch.set_num_threads(1)

B = 4                       # volumes a batch: 4 data ranks split it


def _jmesh(data, space):
    return jmake_mesh(jax.devices()[:data * space], data=data, space=space)


def _smooth_volume(shape, seed):
    """``tests/test_pyramid_pipelined.py``'s input: smoothed noise, scaled."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    v = (v + np.roll(v, 1, 0) + np.roll(v, 1, 1) + np.roll(v, 1, 2)) / 4
    return np.asarray(jpyr.im_scale(jnp.asarray(v)))


def _descriptors(rng, n):
    d = rng.random((n, 768)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _match_inputs(n1, n2, n_near, off):
    rng = np.random.default_rng(42)
    d1 = _descriptors(rng, n1)
    d2 = _descriptors(rng, n2)
    for i in range(n_near):
        d2[i + off] = d1[i] + rng.normal(0, 0.004, 768).astype(np.float32)
        d2[i + off] /= np.linalg.norm(d2[i + off])
    return d1, d2


def _levels_and_kp(rng, shape, K=6):
    levels = np.stack([make_blob_volume(shape, seed=40 + b)
                       for b in range(B)])
    kp = np.stack([
        np.stack([rng.integers(2, shape[0] - 3, K),
                  rng.integers(2, shape[1] - 3, K),
                  rng.integers(2, shape[2] - 3, K)], -1)
        for _ in range(B)]).astype(np.int32)
    return levels, kp


WINDOW_SHAPES = {"z": (16, 18, 14), "y": (6, 16, 14), "x": (6, 14, 16)}
EXT_SHAPES = {"z": (16, 12, 20), "y": (6, 16, 20), "x": (6, 20, 16)}


def make_inputs() -> dict:
    inp = {}
    conv_vols = {
        "conv_local_u0": (make_blob_volume((32, 24, 20), seed=21), 1.6),
        "conv_local_u1": (make_blob_volume((32, 24, 20), seed=21), 1.6),
        "conv_batched": (np.stack([make_blob_volume((16, 16, 16), seed=s)
                                   for s in range(B)]), 1.15),
        "conv_single": (make_blob_volume((16, 16, 16), seed=22), 2.0),
        "conv_y": (make_blob_volume((12, 24, 32), seed=33), 1.2),
        "conv_x": (make_blob_volume((12, 24, 32), seed=33), 1.2),
    }
    for name, (vol, sigma) in conv_vols.items():
        inp[f"{name}/vol"] = vol
        inp[f"{name}/taps"] = gauss_taps(sigma)
    inp["halo/vol"] = np.random.default_rng(3).standard_normal(
        (B, 16, 8, 5)).astype(np.float32)
    for sd, shape in EXT_SHAPES.items():
        for k, base in (("prev", 1), ("cur", 3), ("nxt", 5)):
            inp[f"ext_{sd}/{k}"] = np.stack(
                [make_blob_volume(shape, seed=base + 10 * b)
                 for b in range(B)])
    for sd, shape in WINDOW_SHAPES.items():
        rng = np.random.default_rng(42)
        levels, kp = _levels_and_kp(rng, shape)
        inp[f"orient_{sd}/levels"], inp[f"orient_{sd}/kp"] = levels, kp
        K = kp.shape[1]
        inp[f"desc_{sd}/levels"] = levels
        inp[f"desc_{sd}/centers"] = kp.astype(np.float32) + rng.uniform(
            -0.4, 0.4, kp.shape).astype(np.float32)
        inp[f"desc_{sd}/Q"] = np.stack(
            [[np.linalg.qr(rng.standard_normal((3, 3)))[0]
              for _ in range(K)] for _ in range(B)]).astype(np.float32)
    inp["match/d1"], inp["match/d2"] = _match_inputs(96, 128, 30, 7)
    inp["match_pad/d1"], inp["match_pad/d2"] = _match_inputs(64, 96, 20, 0)
    inp["match_pad/v1"] = np.arange(64) < 50
    inp["match_pad/v2"] = np.arange(96) < 80
    inp["bdd_z/vols"] = np.stack([make_blob_volume((16, 16, 16), seed=s)
                                  for s in (7, 8, 9, 10)])
    inp["bdd_y/vols"] = np.stack([make_blob_volume((8, 24, 24), seed=s)
                                  for s in (7, 8, 9, 10)])
    dense = make_blob_volume((16, 16, 16), seed=7)
    empty = np.zeros((16, 16, 16), np.float32)
    empty[6:10, 6:10, 6:10] = 1.0          # a single blob: <= 1 kp a level
    inp["overflow/vols"] = np.stack([dense, empty, empty, dense])
    inp["pipelined/vols"] = np.stack([_smooth_volume((32, 32, 32), s)
                                      for s in range(B)])
    return inp


def jax_results(inp) -> dict:
    """The JAX package's sharded results, jitted (eager shard_map calls
    compile each step alone and take minutes)."""
    out = {}
    conv_mesh = {"conv_local_u0": (1, 4), "conv_local_u1": (1, 4),
                 "conv_batched": (4, 2), "conv_single": (2, 1),
                 "conv_y": (1, 4), "conv_x": (1, 4)}
    for name, (units, sd, _) in worker.CONV.items():
        mesh = _jmesh(*conv_mesh[name])
        taps = inp[f"{name}/taps"]
        f = jax.jit(lambda v, t=taps, u=units, m=mesh, s=sd:
                    jconv_sharded(v, t, 1.0, u, m, shard_dim=s))
        out[f"{name}/out"] = np.asarray(f(jnp.asarray(inp[f"{name}/vol"])))
    m24 = _jmesh(2, 4)
    for sd in "zyx":
        f = jax.jit(lambda p, c, n, s=sd: jextrema_sharded(
            p, c, n, worker.EXT_THRESH, worker.EXT_CAP, m24, shard_dim=s))
        zyx, count, total = f(*(jnp.asarray(inp[f"ext_{sd}/{k}"])
                                for k in ("prev", "cur", "nxt")))
        out[f"ext_{sd}/zyx"] = np.asarray(zyx)
        out[f"ext_{sd}/count"] = np.asarray(count)
        out[f"ext_{sd}/total"] = np.asarray(total)
        f = jax.jit(lambda lv, kp, s=sd: jwin.orient_level_sharded(
            lv, kp, worker.WINDOW_SD, worker.WINDOW_UNITS, worker.CORNER,
            m24, shard_dim=s))
        R, valid = f(jnp.asarray(inp[f"orient_{sd}/levels"]),
                     jnp.asarray(inp[f"orient_{sd}/kp"]))
        out[f"orient_{sd}/R"], out[f"orient_{sd}/valid"] = \
            np.asarray(R), np.asarray(valid)
        f = jax.jit(lambda lv, c, q, s=sd: jwin.descrip_level_sharded(
            lv, c, q, worker.WINDOW_SD, worker.WINDOW_UNITS, m24,
            shard_dim=s))
        out[f"desc_{sd}/vec"] = np.asarray(f(*(
            jnp.asarray(inp[f"desc_{sd}/{k}"])
            for k in ("levels", "centers", "Q"))))
    m14 = _jmesh(1, 4)
    for name, key, mesh, fn, kw in (
            ("match", "match", m14, jmatch.nn_match_sharded, {}),
            ("match_pad", "match_pad", m24, jmatch.nn_match_sharded, {}),
            ("match_streamed", "match", m14, jmatch.nn_match_sharded,
             dict(streamed=True)),
            ("ring", "match", m14, jmatch.nn_match_ring, {}),
            ("ring_pad", "match_pad", m24, jmatch.nn_match_ring, {})):
        v = {f"valid{i}": jnp.asarray(inp[f"{key}/v{i}"]) for i in (1, 2)
             if f"{key}/v{i}" in inp}
        f = jax.jit(lambda d1, d2, v, m=mesh, g=fn, k=kw: g(
            d1, d2, worker.NN_THRESH, m, **v, **k))
        out[f"{name}/matches"] = np.asarray(f(
            jnp.asarray(inp[f"{key}/d1"]), jnp.asarray(inp[f"{key}/d2"]), v))
    for name, (shape, units, cap, sd) in worker.PIPES.items():
        params = JParams(max_kp_per_level=cap)
        plan = jpyr.plan_pyramid(shape[::-1], units, params)
        f = jax.jit(lambda v, p=plan, q=params, s=sd:
                    jpipe.batch_detect_describe(v, p, q, m24, shard_dim=s))
        kp, desc, ov = f(jnp.asarray(inp[f"{name}/vols"]))
        for k in ("x", "y", "z", "o", "s", "sd", "R", "count"):
            out[f"{name}/{k}"] = np.asarray(getattr(kp, k))
        out[f"{name}/vec"] = np.asarray(desc.vec)
        out[f"{name}/xyz"] = np.asarray(desc.xyz)
        out[f"{name}/overflow"] = np.asarray(ov)
    m21 = _jmesh(2, 1)
    for cap in (1, 512):
        params = JParams(max_kp_per_level=cap)
        plan = jpyr.plan_pyramid((16, 16, 16), (1.0, 1.0, 1.0), params)
        f = jax.jit(lambda v, p=plan, q=params:
                    jpipe.batch_detect_describe(v, p, q, m21)[2])
        out[f"overflow/ov{cap}"] = np.asarray(f(jnp.asarray(
            inp["overflow/vols"])))
    plan = jpyr.plan_pyramid((32, 32, 32), (1.0, 1.0, 1.0), JParams())
    f = jax.jit(lambda v: jpipe.build_gpyr_batched(v, plan, _jmesh(4, 1),
                                                   pipelined=True))
    for (o, s), lv in f(jnp.asarray(inp["pipelined/vols"])).items():
        out[f"pipelined/pip_{o}_{s}"] = np.asarray(lv)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, JAX's results and the port's from one 4-rank world; the
    world runs while the JAX side computes."""
    d = tmp_path_factory.mktemp("parallel_world")
    inp = make_inputs()
    np.savez(d / "inputs.npz", **inp)
    import threading
    box = {}
    t = threading.Thread(target=lambda: box.update(zip(
        ("results", "errors", "failure"),
        worker.run_world("parallel", d / "inputs.npz", d))))
    t.start()
    try:
        jax_out = jax_results(inp)
    finally:
        t.join()
    return inp, jax_out, box["results"], box["errors"], box["failure"]


def _port(world, case, mesh):
    inp, jax_out, results, errors, failure = world
    assert not failure, failure
    key = f"{case}/{mesh}"
    assert key not in errors, errors[key]
    got = {k[len(key) + 1:]: v for k, v in results.items()
           if k.startswith(key + "/")}
    assert got, f"no result for {key}"
    return inp, jax_out, got


@pytest.mark.parametrize("n", [8, 4, 6, 1, 16, 12])
def test_factor_devices_matches_jax(n):
    assert factor_devices(n) == jfactor_devices(n)


@pytest.mark.parametrize("case,mesh", [c for c in worker.cases("parallel")
                                       if c[0].startswith("conv_")])
def test_conv_sep_sharded(world, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    units, sd, _ = worker.CONV[case]
    tol = 2e-6 if sd == "z" else 2e-5
    np.testing.assert_allclose(got["out"], jax_out[f"{case}/out"], rtol=0,
                               atol=tol)
    want = tconv.conv_sep(torch.as_tensor(inp[f"{case}/vol"]),
                          inp[f"{case}/taps"], 1.0, units).numpy()
    np.testing.assert_allclose(got["out"], want, rtol=0, atol=tol)


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "4x1"])
def test_shard_halo_and_layout(world, mesh):
    """Each rank's halo-extended slab holds its neighbours' edge planes
    and zeros past the volume; ranks sit at rank = d * space + s."""
    inp, _, got = _port(world, "halo", mesh)
    data, space = map(int, mesh.split("x"))
    vol = inp["halo/vol"]
    for sd in ("z", "y"):
        ax = 1 + worker.DIMS[sd]
        L = vol.shape[ax] // space
        pad = [(0, 0)] * 4
        pad[ax] = (2, 2)
        padded = np.pad(vol, pad)
        want = np.concatenate([np.take(padded, range(s * L, s * L + L + 4),
                                       axis=ax) for s in range(space)],
                              axis=ax)
        np.testing.assert_array_equal(got[sd], want)
    _, _, lay = _port(world, "layout", mesh)
    for row in lay["space"].tolist() + lay["data"].tolist():
        assert row[0] == row[1] * space + row[2]
    assert sorted(r[2] for r in lay["space"].tolist()) == list(range(space))
    assert sorted(r[1] for r in lay["data"].tolist()) == list(range(data))


@pytest.mark.parametrize("case,mesh", [c for c in worker.cases("parallel")
                                       if c[0].startswith("ext_")])
def test_level_extrema_sharded(world, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    for k in ("zyx", "count", "total"):
        np.testing.assert_array_equal(got[k], jax_out[f"{case}/{k}"])
    rows, count, total = level_extrema(
        *(torch.as_tensor(inp[f"{case}/{k}"]) for k in ("prev", "cur", "nxt")),
        worker.EXT_THRESH, worker.EXT_CAP)
    np.testing.assert_array_equal(got["count"], count.numpy())
    np.testing.assert_array_equal(got["total"], total.numpy())
    for b in range(B):
        np.testing.assert_array_equal(
            got["zyx"][b, :int(count[b])], rows[rows[:, 0] == b, 1:].numpy())
    assert got["count"].sum() > 0


@pytest.mark.parametrize("case,mesh", [c for c in worker.cases("parallel")
                                       if c[0].startswith("orient_")])
def test_orient_level_sharded(world, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    np.testing.assert_array_equal(got["valid"], jax_out[f"{case}/valid"])
    ok = got["valid"]
    assert ok.any()
    np.testing.assert_allclose(got["R"][ok], jax_out[f"{case}/R"][ok],
                               rtol=0, atol=2e-4)
    for b in range(B):
        R1, v1 = assign_orientations_level(
            torch.as_tensor(inp[f"{case}/levels"][b]),
            torch.as_tensor(inp[f"{case}/kp"][b]), worker.WINDOW_SD,
            worker.WINDOW_UNITS, worker.CORNER)
        np.testing.assert_array_equal(got["valid"][b], v1.numpy())
        np.testing.assert_allclose(got["R"][b][v1.numpy()],
                                   R1[v1].numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("case,mesh", [c for c in worker.cases("parallel")
                                       if c[0].startswith("desc_")])
def test_descrip_level_sharded(world, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    np.testing.assert_allclose(got["vec"], jax_out[f"{case}/vec"], rtol=0,
                               atol=2e-4)
    for b in range(B):
        want = extract_level(
            torch.as_tensor(inp[f"{case}/levels"][b]),
            torch.as_tensor(inp[f"{case}/centers"][b]),
            torch.as_tensor(inp[f"{case}/Q"][b]), worker.WINDOW_SD,
            worker.WINDOW_UNITS)
        np.testing.assert_allclose(got["vec"][b], want.numpy(), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("case,mesh", [
    c for c in worker.cases("parallel")
    if c[0].startswith(("match", "ring"))])
def test_nn_match_sharded_and_ring(world, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    np.testing.assert_array_equal(got["matches"],
                                  jax_out[f"{case}/matches"])
    key = "match_pad" if case.endswith("_pad") else "match"
    v = {f"valid{i}": torch.as_tensor(inp[f"{key}/v{i}"]) for i in (1, 2)
         if f"{key}/v{i}" in inp}
    want = nn_match(torch.as_tensor(inp[f"{key}/d1"]),
                    torch.as_tensor(inp[f"{key}/d2"]), worker.NN_THRESH, **v)
    np.testing.assert_array_equal(got["matches"], want.numpy())
    jv = {k: jnp.asarray(t.numpy()) for k, t in v.items()}
    np.testing.assert_array_equal(got["matches"], np.asarray(jnn_match(
        jnp.asarray(inp[f"{key}/d1"]), jnp.asarray(inp[f"{key}/d2"]),
        worker.NN_THRESH, **jv)))
    assert (got["matches"] >= 0).sum() >= 15


@pytest.fixture(scope="module")
def unsharded(world):
    """The port's one-device batch_detect_describe of each pipeline."""
    inp = world[0]
    out = {}
    for name, (shape, units, cap, _) in worker.PIPES.items():
        params = SIFT3DParams(max_kp_per_level=cap)
        plan = tpyr.plan_pyramid(shape[::-1], units, params)
        out[name] = tpipe.batch_detect_describe(inp[f"{name}/vols"], plan,
                                                params, device="cpu")
    return out


@pytest.mark.parametrize("case,mesh", [c for c in worker.cases("parallel")
                                       if c[0].startswith("bdd_")])
def test_batch_detect_describe_mesh(world, unsharded, case, mesh):
    inp, jax_out, got = _port(world, case, mesh)
    counts = got["count"]
    np.testing.assert_array_equal(counts, jax_out[f"{case}/count"])
    assert not got["overflow"].any()
    np.testing.assert_array_equal(got["overflow"],
                                  jax_out[f"{case}/overflow"])
    assert counts.sum() > 0
    kp1, desc1, _ = unsharded[case]
    np.testing.assert_array_equal(counts, kp1.count.numpy())
    for b, n in enumerate(counts):
        for k in ("x", "y", "z", "o", "s", "sd"):
            np.testing.assert_array_equal(got[k][b, :n],
                                          jax_out[f"{case}/{k}"][b, :n])
            np.testing.assert_array_equal(got[k][b, :n],
                                          getattr(kp1, k)[b, :n].numpy())
        np.testing.assert_allclose(got["R"][b, :n],
                                   jax_out[f"{case}/R"][b, :n], rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(got["vec"][b, :n],
                                   jax_out[f"{case}/vec"][b, :n], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["vec"][b, :n],
                                   desc1.vec[b, :n].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["xyz"][b, :n],
                                      jax_out[f"{case}/xyz"][b, :n])


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "4x1"])
def test_overflow_flag_mesh(world, mesh):
    """The dense volumes trip kp_overflow at one keypoint a level, the
    near-empty ones do not; at 512 none does; batch_register_pairs(mesh=)
    carries the flag into its result."""
    inp, jax_out, got = _port(world, "overflow", mesh)
    np.testing.assert_array_equal(got["ov1"], jax_out["overflow/ov1"])
    np.testing.assert_array_equal(got["ov512"], jax_out["overflow/ov512"])
    np.testing.assert_array_equal(got["ov1"], [True, False, False, True])
    assert not got["ov512"].any()
    np.testing.assert_array_equal(got["reg_overflow"], got["ov1"])
    np.testing.assert_array_equal(got["reg_A_shape"], [B, 3, 4])


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "4x1"])
def test_build_gpyr_batched_pipelined(world, mesh):
    """At space 1 ``pipelined=True`` gives the composed-operator levels
    within 2e-6 of sequential; at space > 1 both builds are the sharded
    sequential one. Both within 2e-6 of JAX's pipelined batch and of the
    port's one-device sequential pyramid."""
    inp, jax_out, got = _port(world, "pipelined", mesh)
    vols = torch.as_tensor(inp["pipelined/vols"])
    plan = tpyr.plan_pyramid((32, 32, 32), (1.0, 1.0, 1.0), SIFT3DParams())
    seq = tpyr.build_gpyr(vols, plan)
    for (o, s), want in seq.items():
        for label in ("pip", "seq"):
            lv = got[f"{label}_{o}_{s}"]
            np.testing.assert_allclose(lv, want.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{label} {(o, s)}")
            np.testing.assert_allclose(
                lv, jax_out[f"pipelined/pip_{o}_{s}"], rtol=0, atol=2e-6,
                err_msg=f"{label} {(o, s)}")


# --- the pipelined pyramid on one device (no world) -------------------------

@pytest.mark.parametrize("shape,units", [
    ((32, 32, 32), (1.0, 1.0, 1.0)),
    ((40, 32, 24), (1.0, 1.5, 2.0)),     # non-cubic, anisotropic
])
def test_build_gpyr_pipelined_matches_jax(shape, units):
    vol = _smooth_volume(shape, 0)
    plan = tpyr.plan_pyramid(shape[::-1], units, SIFT3DParams())
    jplan = jpyr.plan_pyramid(shape[::-1], units, JParams())
    got = tpyr.build_gpyr_pipelined(torch.as_tensor(vol), plan)
    seq = tpyr.build_gpyr(torch.as_tensor(vol), plan)
    want = jax.jit(lambda v: jpyr.build_gpyr_pipelined(v, jplan))(
        jnp.asarray(vol))
    assert set(got) == set(seq) == set(want)
    for key in seq:
        np.testing.assert_allclose(got[key].numpy(), seq[key].numpy(),
                                   rtol=0, atol=2e-6, err_msg=f"{key}")
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-6, err_msg=f"{key}")


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 32, 24)])
def test_composed_operators_match_jax(shape):
    """The host-side operators equal the JAX package's bit for bit, with
    the dependency-depth shapes of ``test_pyramid_pipelined.py``."""
    plan = tpyr.plan_pyramid(shape, (1.0, 1.5, 2.0), SIFT3DParams())
    seed_ops, level_ops = tpyr.composed_pyramid_operators(plan)
    jseed, jlevel = jpyr.composed_pyramid_operators(
        jpyr.plan_pyramid(shape, (1.0, 1.5, 2.0), JParams()))
    assert seed_ops[0] is None and jseed[0] is None
    for o in range(1, plan.num_octaves):
        assert tuple(m.shape for m in seed_ops[o]) == tuple(
            (n, b) for n, b in zip(plan.octave_dims(o), plan.dims))
        for a, b in zip(seed_ops[o], jseed[o]):
            np.testing.assert_array_equal(a, b)
    assert set(level_ops) == set(jlevel)
    for key, ops in level_ops.items():
        n3 = plan.octave_dims(key[0])
        assert tuple(m.shape for m in ops) == tuple((n, n) for n in n3)
        for a, b in zip(ops, jlevel[key]):
            np.testing.assert_array_equal(a, b)


def test_conv_axis_rectangular_operator():
    """``conv_axis`` applies a rectangular (n_out, n) operator along any
    axis, as a composed seed projection needs."""
    rng = np.random.default_rng(0)
    vol = torch.as_tensor(rng.standard_normal((2, 5, 6, 7)),
                          dtype=torch.float32)
    for axis in (1, 2, 3):
        W = rng.standard_normal((3, vol.shape[axis])).astype(np.float32)
        got = tconv.conv_axis(vol, W, axis).numpy()
        want = np.moveaxis(np.tensordot(W, vol.numpy(), ([1], [axis])), 0,
                           axis)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_signatures():
    """The pipeline entry points take ``mesh=`` and ``pipelined=`` and the
    one-device path keeps its results with ``pipelined=True`` (levels
    within 2e-6 of sequential) on the CPU."""
    import inspect
    for fn in (tpipe.batch_detect_describe, tpipe.batch_register_pairs):
        sig = inspect.signature(fn)
        assert "mesh" in sig.parameters and "pipelined" in sig.parameters
    params = SIFT3DParams(max_kp_per_level=128)
    vols = np.stack([make_blob_volume((16, 16, 16), seed=s) for s in (7, 8)])
    plan = tpyr.plan_pyramid((16, 16, 16), (1.0, 1.0, 1.0), params)
    a = tpipe.batch_detect_describe(vols, plan, params, device="cpu")
    b = tpipe.batch_detect_describe(vols, plan, params, device="cpu",
                                    pipelined=True)
    np.testing.assert_array_equal(a[0].count.numpy(), b[0].count.numpy())
    assert dataclasses.is_dataclass(a[1])
