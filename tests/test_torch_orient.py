"""Port parity: the orientation window sums (kernel 3's plain version) and
orientation assignment.

The same numpy levels and keypoint rows go through the JAX package's
eager window path (``_window_terms``, float64 sums), its Pallas kernel in
interpret mode (``orient_terms_pallas``, float32 sums, batched by
``jax.vmap``) and the port's ``orient_terms_plain``. Tolerances are
relative to each row's largest |term|: the six tensor sums within 1e-6 of
the float64 path (the two differ only in summation order); the window
gradient, an fp32 sum on every side, and everything against the Pallas
kernel's fp32 sums within 1e-5.
The cases are those of ``tests/test_pallas_orient.py``: anisotropic
units, windows clamped at both level edges, and rows past ``count``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift3d_tpu.features import orientation as jori
from sift3d_tpu.ops.pallas_orient import orient_terms_pallas

from sift3d_tpu_torch.features import orientation as tori
from sift3d_tpu_torch.ops.cuda_orient import orient_terms, orient_terms_plain

torch.set_num_threads(1)

SHAPE = (24, 28, 20)
UNITS = (1.0, 1.3, 0.8)
SD = 1.6
K, COUNT = 9, 7


def _level(rng, shape):
    nz, ny, nx = shape
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    vol = np.zeros(shape)
    for _ in range(30):
        c = rng.uniform(0, nz, 3)
        s = rng.uniform(1.5, 4.0)
        vol += rng.uniform(-1, 1) * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
            / (2 * s * s))
    return vol.astype(np.float32)


def _rows(rng, n):
    zyx = np.stack([rng.integers(1, s - 1, n) for s in SHAPE],
                   -1).astype(np.int32)
    zyx[0] = (1, 1, 1)                                   # clamped low
    zyx[1] = tuple(s - 2 for s in SHAPE)                 # clamped high
    return zyx


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(42)
    levels = np.stack([_level(rng, SHAPE) for _ in range(3)])
    zyx = _rows(rng, K)
    sigma, rad, radii, cores = tori.level_geometry(SD, UNITS, SHAPE)
    assert radii == tuple(
        int(r) for r in reversed(jori.window_radii(rad, UNITS)))
    geom = (radii, cores, UNITS, sigma, rad)
    # JAX's float64 eager path, one row at a time (vmapped).
    A64, vd64 = jax.vmap(lambda r: jori._window_terms(
        jnp.asarray(levels[0]), r, radii, cores, UNITS, rad, sigma))(
        jnp.asarray(zyx))
    # JAX's Pallas kernel in interpret mode, with a count skip.
    Ap, vdp = orient_terms_pallas(jnp.asarray(levels[0]), jnp.asarray(zyx),
                                  jnp.int32(COUNT), radii, cores, UNITS,
                                  float(sigma), float(rad), interpret=True)
    # jax.vmap of the Pallas kernel (its batching rule) over the three
    # levels, 4 rows each, with per-volume counts.
    zyx_b = np.stack([_rows(rng, 4) for _ in range(3)])
    counts = np.array([4, 2, 3], np.int32)
    A_b, vd_b = jax.vmap(lambda lv, z, c: orient_terms_pallas(
        lv, z, c, radii, cores, UNITS, float(sigma), float(rad),
        interpret=True))(jnp.asarray(levels), jnp.asarray(zyx_b),
                         jnp.asarray(counts))
    # Orientation of many rows of the second level (float64 eager path).
    zyx_many = _rows(rng, 60)
    R_j, valid_j = jori.assign_orientations_level(
        jnp.asarray(levels[1]), jnp.asarray(zyx_many), SD, UNITS, 0.4)
    return dict(levels=levels, zyx=zyx, geom=geom,
                eager=(np.asarray(A64), np.asarray(vd64)),
                pallas=(np.asarray(Ap), np.asarray(vdp)),
                vmap=(zyx_b, counts, np.asarray(A_b), np.asarray(vd_b)),
                assign=(zyx_many, np.asarray(R_j), np.asarray(valid_j)))


def _assert_rows_close(got, want, rtol_A, rtol_vd=1e-5):
    A, vd = (t.numpy().astype(np.float64) for t in got)
    wA, wvd = (np.asarray(t, np.float64) for t in want)
    scale = np.maximum(np.abs(wA).max(1), np.abs(wvd).max(1))[:, None]
    assert (scale > 0).all()
    assert (np.abs(A - wA) / scale).max() <= rtol_A
    assert (np.abs(vd - wvd) / scale).max() <= rtol_vd


def test_terms_match_float64_eager(case):
    got = orient_terms_plain(torch.as_tensor(case["levels"][0]),
                             torch.as_tensor(case["zyx"]), K, *case["geom"])
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.float32
    _assert_rows_close(got, case["eager"], 1e-6)


def test_terms_match_pallas_interpret_with_count(case):
    got = orient_terms(torch.as_tensor(case["levels"][0]),
                       torch.as_tensor(case["zyx"]), COUNT, *case["geom"])
    _assert_rows_close((g[:COUNT] for g in got),
                       (w[:COUNT] for w in case["pallas"]), 1e-5)
    for g, w in zip(got, case["pallas"]):
        assert torch.all(g[COUNT:] == 0) and np.all(w[COUNT:] == 0)


def test_batched_rows_match_jax_vmap(case):
    """Rows of three volumes in one call, each row tagged with its volume,
    against ``jax.vmap`` of the Pallas kernel (its batching rule)."""
    zyx_b, counts, A_b, vd_b = case["vmap"]
    keep = np.concatenate([np.arange(c) + 4 * b
                           for b, c in enumerate(counts)])
    vol = torch.as_tensor(np.repeat(np.arange(3), 4)[keep])
    got = orient_terms(torch.as_tensor(case["levels"]),
                       torch.as_tensor(zyx_b.reshape(-1, 3)[keep]),
                       len(keep), *case["geom"], vol=vol)
    _assert_rows_close(got, (A_b.reshape(-1, 6)[keep],
                             vd_b.reshape(-1, 3)[keep]), 1e-5)


def test_assign_orientations_level_matches_jax(case):
    """Orientation of many rows of a blob level: valid exact, R within
    1e-5 (JAX on the CPU takes its float64 eager path)."""
    zyx, R_j, valid_j = case["assign"]
    R_t, valid_t = tori.assign_orientations_level(
        torch.as_tensor(case["levels"][1]), torch.as_tensor(zyx), SD, UNITS,
        0.4)
    assert valid_j.sum() >= 5, "too few valid rows to be a real test"
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    np.testing.assert_allclose(R_t.numpy()[valid_j], R_j[valid_j], rtol=0,
                               atol=1e-5)
