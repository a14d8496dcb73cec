"""Port parity: the examples (``examples/torch/*.py``) beside the JAX
package's (``examples/*.py``).

Each port example's ``main(..., device="cpu")`` runs in process beside the
JAX example's ``main``, both loaded from their paths, on the same NIfTI
files: 40^3 volumes of ``benches.data.make_volume`` and copies rolled by
known shifts. The printed lines are read as a user reads them:
``features`` and ``io`` print the same lines (stage timings aside);
``register`` and ``groupwise`` print affines inside the 5e-2 / 5-voxel
contract of the known shift and of each other (RANSAC draws differ
between the packages); ``nonrigid`` writes a volume of the reference's
shape.
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from benches.data import make_volume
from chip_smoke import printed_affines
from sift3d_tpu import utils as jutils
from sift3d_tpu_torch import utils as putils
from sift3d_tpu_torch.io import Volume, im_read, im_write

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (40, 40, 40)
ROLL = (1, -2, 2)                          # ref = src rolled (z, y, x)
GW_ROLLS = ((0, 0, 0), (1, -2, 2), (-2, 1, 1))
LIN_TOL, T_TOL = 5e-2, 5.0                 # Sift3DTest.m:319-324


def _load(pkg: str, name: str):
    """The ``main`` of ``examples/<name>.py`` (JAX) or
    ``examples/torch/<name>.py`` (port), loaded from its path."""
    path = ROOT / "examples" / ("torch" if pkg == "port" else "") / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{pkg}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _run(pkg, name, capsys, *args):
    """(exit code, printed lines) of one example's ``main``."""
    kw = {"device": "cpu"} if pkg == "port" else {}
    rc = _load(pkg, name)(*args, **kw)
    return rc, capsys.readouterr().out.splitlines()


def _both(name, capsys, args_of):
    """Both packages' runs of one example; ``args_of(pkg)`` gives its
    arguments."""
    out = {}
    for pkg in ("jax", "port"):
        rc, lines = _run(pkg, name, capsys, *args_of(pkg))
        assert rc == 0, (pkg, lines)
        out[pkg] = lines
    return out


def _truth(roll):
    """The affine (ref -> src voxels) of a copy rolled by ``roll`` (z, y,
    x): identity, translation -roll in (x, y, z)."""
    A = np.zeros((3, 4))
    A[:, :3] = np.eye(3)
    A[:, 3] = -np.asarray(roll, np.float64)[::-1]
    return A


def _inside(A, want):
    return (np.abs(A[:, :3] - want[:, :3]).max() < LIN_TOL and
            np.abs(A[:, 3] - want[:, 3]).max() < T_TOL)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    base = make_volume(SHAPE, nblob=60, seed=7)
    paths = {"img": d / "img.nii", "src": d / "src.nii", "ref": d / "ref.nii"}
    im_write(str(paths["img"]), Volume(base, (1.0, 1.0, 1.5)))
    im_write(str(paths["src"]), Volume(base))
    im_write(str(paths["ref"]), Volume(np.roll(base, ROLL, (0, 1, 2))))
    for i, r in enumerate(GW_ROLLS):
        paths[f"g{i}"] = d / f"g{i}.nii"
        im_write(str(paths[f"g{i}"]), Volume(np.roll(base, r, (0, 1, 2))))
    return d, {k: str(v) for k, v in paths.items()}


@pytest.fixture()
def quiet_logs():
    """The features example routes log records to ``print`` in its
    package; silence both packages again afterwards."""
    yield
    jutils.set_log_fn(None)
    putils.set_log_fn(None)


def _records(lines):
    """(the lines that are not log records, the records without their
    timings)."""
    text, recs = [], []
    for line in lines:
        if line.startswith("{"):
            rec = ast.literal_eval(line)
            for k in ("seconds", "total_seconds"):
                rec.pop(k, None)
            if "stages" in rec:
                rec["stages"] = sorted(rec["stages"])
            recs.append(rec)
        else:
            text.append(line)
    return text, recs


def test_features_example_matches_jax(files, capsys, quiet_logs):
    _, p = files
    out = _both("features", capsys, lambda pkg: (p["src"],))
    (t_j, r_j), (t_p, r_p) = _records(out["jax"]), _records(out["port"])
    assert t_p == t_j
    assert r_p == r_j and [r["kind"] for r in r_p] == ["stage", "stage",
                                                       "timing"]
    n = int(t_p[0].split()[1])
    assert t_p[0] == f"detected {n} keypoints" and n >= 10
    assert t_p[1].startswith(f"descriptor matrix: ({n}, 771)")


def test_io_example_matches_jax(files, capsys):
    d, p = files
    out = _both("io", capsys,
                lambda pkg: (p["img"], str(d / f"{pkg}_io.nii.gz")))
    assert out["port"][:2] == out["jax"][:2] == [
        "dims (x, y, z): (40, 40, 40)  channels: 1",
        "units (mm): (1.0, 1.0, 1.5)"]
    assert out["port"][2] == f"wrote {d / 'port_io.nii.gz'}"
    src = im_read(p["img"])
    for pkg in ("jax", "port"):
        back = im_read(str(d / f"{pkg}_io.nii.gz"))
        np.testing.assert_array_equal(back.data, src.data)
        assert back.units == src.units


def test_register_example_matches_jax(files, capsys):
    d, p = files
    out = _both("register", capsys,
                lambda pkg: (p["src"], p["ref"], str(d / f"{pkg}_w.nii")))
    want = _truth(ROLL)
    A = {pkg: printed_affines(out[pkg], "affine (ref -> src voxels):")
         for pkg in out}
    assert len(A["port"]) == len(A["jax"]) == 1
    assert _inside(A["port"][0], want) and _inside(A["jax"][0], want)
    assert _inside(A["port"][0], A["jax"][0])
    rep = {pkg: ast.literal_eval(out[pkg][4]) for pkg in out}
    assert rep["port"].keys() == rep["jax"].keys()
    assert rep["port"]["registration_ok"] and rep["jax"]["registration_ok"]
    assert out["port"][-1] == f"wrote {d / 'port_w.nii'}"
    ref = im_read(p["ref"])
    for pkg in ("jax", "port"):
        w = im_read(str(d / f"{pkg}_w.nii"))
        assert w.data.shape == ref.data.shape and w.units == ref.units
        assert np.isfinite(w.data).all()


def test_nonrigid_example_matches_jax(files, capsys):
    d, p = files
    out = _both("nonrigid", capsys,
                lambda pkg: ([p["src"], p["ref"], str(d / f"{pkg}_n.nii")],))
    counts = {}
    for pkg, lines in out.items():
        assert len(lines) == 1, lines
        w = lines[0].replace(",", "").split()
        counts[pkg] = (int(w[0]), int(w[2]), int(w[5]))
        # The spline's control points are the affine's inliers.
        assert counts[pkg][1] == counts[pkg][2] >= 4
    assert counts["port"][0] == counts["jax"][0]          # matches exact
    ref = im_read(p["ref"])
    for pkg in ("jax", "port"):
        w = im_read(str(d / f"{pkg}_n.nii"))
        assert w.data.shape == ref.data.shape and w.units == ref.units
        assert np.isfinite(w.data).all() and np.abs(w.data).max() > 0


def test_groupwise_example_matches_jax(files, capsys):
    _, p = files
    vols = [p[f"g{i}"] for i in range(len(GW_ROLLS))]
    out = _both("groupwise", capsys, lambda pkg: (vols,))
    n = len(vols)
    assert out["port"][:n] == out["jax"][:n]               # keypoint counts
    A = {pkg: printed_affines(out[pkg], "A[") for pkg in out}
    assert len(A["port"]) == len(A["jax"]) == n
    np.testing.assert_array_equal(A["port"][0], _truth((0, 0, 0)))
    for i, r in enumerate(GW_ROLLS):
        assert _inside(A["port"][i], _truth(r)), (i, A["port"][i])
        assert _inside(A["jax"][i], _truth(r)), (i, A["jax"][i])
        assert _inside(A["port"][i], A["jax"][i])
