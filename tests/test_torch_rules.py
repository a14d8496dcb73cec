"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points refuse to run on the CPU unless asked, and every kernel
wrapper dispatches by the device of its input (plain version on the CPU)."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sift3d_tpu_torch import RegSift3D, Sift3D
from sift3d_tpu_torch.api import (assign_orientations, descriptors_from_rows,
                                  warp)
from sift3d_tpu_torch.config import MatchParams, RansacParams, SIFT3DParams
from sift3d_tpu_torch.convert import descriptors_from_numpy, params_from_dict
from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.ops import (cuda_extrema, cuda_match, cuda_orient,
                                  cuda_window)
from sift3d_tpu_torch.parallel import pipeline as tpipe
from sift3d_tpu_torch.register.groupwise import (groupwise_solve,
                                                 register_groupwise)
from sift3d_tpu_torch.utils import trace
from sift3d_tpu_torch.utils.checkpoint import (load_descriptors,
                                               load_keypoints)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sift3d_tpu_torch"
EXAMPLES = ROOT / "examples" / "torch"


def test_import_pulls_in_no_jax():
    code = ("import sys, sift3d_tpu_torch, sift3d_tpu_torch.api, "
            "sift3d_tpu_torch.convert, sift3d_tpu_torch.ops.cuda_match, "
            "sift3d_tpu_torch.ops.cuda_window, "
            "sift3d_tpu_torch.ops.cuda_orient, "
            "sift3d_tpu_torch.ops.cuda_extrema, "
            "sift3d_tpu_torch.parallel.pipeline, sift3d_tpu_torch.io, "
            "sift3d_tpu_torch.io.dicom, sift3d_tpu_torch.cli.kp, "
            "sift3d_tpu_torch.cli.reg, sift3d_tpu_torch.ops.interp, "
            "sift3d_tpu_torch.ops.draw, sift3d_tpu_torch.features.dense, "
            "sift3d_tpu_torch.cli.dense, sift3d_tpu_torch.register.tps, "
            "sift3d_tpu_torch.register, sift3d_tpu_torch.register.groupwise, "
            "sift3d_tpu_torch.utils, sift3d_tpu_torch.utils.trace, "
            "sift3d_tpu_torch.utils.roofline, "
            "sift3d_tpu_torch.utils.checkpoint, sift3d_tpu_torch.parallel, "
            "sift3d_tpu_torch.parallel.mesh, "
            "sift3d_tpu_torch.parallel.shard_conv, "
            "sift3d_tpu_torch.parallel.shard_extrema, "
            "sift3d_tpu_torch.parallel.shard_match, "
            "sift3d_tpu_torch.parallel.shard_windows\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'sift3d_tpu.')) or "
            "m == 'sift3d_tpu']\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + list(EXAMPLES.glob("*.py")) +
    [ROOT / "chip_smoke.py"]))
def test_sources_name_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "sift3d_tpu"), (path, name)


def test_utils_import_no_ops():
    """``utils/`` (tracing, checkpoints, rooflines) sits below ``ops``:
    none of its modules imports ``sift3d_tpu_torch.ops``."""
    for path in sorted((PORT / "utils").glob("*.py")):
        package = ["sift3d_tpu_torch", "utils"]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = package[:len(package) - node.level + 1] \
                    if node.level else []
                module = ".".join(base + ([node.module] if node.module
                                          else []))
                names = [module] + [f"{module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                assert not (name + ".").startswith("sift3d_tpu_torch.ops."), \
                    (path.name, name)


def test_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    vol = np.zeros((16, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Sift3D()
    with pytest.raises(RuntimeError, match="CUDA"):
        Sift3D().dense(vol)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegSift3D()
    with pytest.raises(RuntimeError, match="CUDA"):
        RegSift3D().register_tps(vol, vol)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        warp(vol, np.eye(3, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        assign_orientations(vol, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors_from_rows(np.zeros((1, 771)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.batch_register_pairs(np.zeros((1, 16, 16, 16)),
                                   np.zeros((1, 16, 16, 16)), None,
                                   SIFT3DParams())
    edges = np.array([(0, 1)])
    pts = np.zeros((1, 8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        groupwise_solve(edges, pts, pts, np.array([8]), 2)
    desc = dict(xyz=np.zeros((2, 4, 3)), sd=np.zeros((2, 4)),
                vec=np.zeros((2, 4, 768), np.float32), count=np.array([4, 4]))
    with pytest.raises(RuntimeError, match="CUDA"):
        # Descriptors on the card cannot be made without one.
        register_groupwise(descriptors_from_numpy(**desc, device="cuda"),
                           edges, (1.0, 1.0, 1.0))
    np.savez(tmp_path / "d.npz", xyz=np.zeros((1, 3)), sd=np.zeros(1),
             vec=np.zeros((1, 768), np.float32))
    np.savez(tmp_path / "k.npz", rows=np.zeros((1, 14)),
             s=np.zeros(1, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_descriptors(str(tmp_path / "d.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_keypoints(str(tmp_path / "k.npz"))
    assert resolve_device("cpu") == torch.device("cpu")
    # On the CPU when asked (register_groupwise where its descriptors are).
    assert groupwise_solve(edges, pts, pts, np.array([8]), 2,
                           device="cpu").A.shape == (2, 3, 4)
    assert register_groupwise(descriptors_from_numpy(**desc), edges,
                              (1.0, 1.0, 1.0)).A.device.type == "cpu"
    assert load_descriptors(str(tmp_path / "d.npz"), device="cpu").count == 1
    assert load_keypoints(str(tmp_path / "k.npz"), device="cpu").count == 1
    # Sift3D.dense and RegSift3D.register_tps on the CPU when asked.
    assert Sift3D(device="cpu").dense(vol).shape == (12, 16, 16, 16)
    assert RegSift3D(device="cpu").register_tps(vol, vol)[1] is None
    # The examples refuse before they read anything; with device="cpu"
    # they go on to read their (missing) inputs.
    import importlib.util
    from sift3d_tpu_torch.io import FileDoesNotExistError
    missing = str(tmp_path / "missing.nii")
    for name, args in (("features", (missing,)), ("io", (missing, missing)),
                       ("register", (missing, missing, missing)),
                       ("nonrigid", ([missing] * 3,)),
                       ("groupwise", ([missing] * 2,))):
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(*args)
        with pytest.raises(FileDoesNotExistError):
            mod.main(*args, device="cpu")


def _cpu_mesh():
    """A one-rank mesh object on the CPU (no process group behind it: the
    entry points below must refuse before they use it)."""
    from sift3d_tpu_torch.parallel.mesh import Mesh
    return Mesh(1, 1, 0, 0, torch.device("cpu"), {})


def _gw_desc():
    return descriptors_from_numpy(
        xyz=np.zeros((2, 4, 3)), sd=np.zeros((2, 4)),
        vec=np.zeros((2, 4, 768), np.float32), count=np.array([4, 4]))


@pytest.mark.parametrize("entry", [
    "init_distributed", "make_mesh", "batch_detect_describe",
    "batch_register_pairs", "groupwise_solve_sharded",
    "register_groupwise_sharded"])
def test_mesh_entry_points_refuse_cpu_fallback(entry):
    """The multi-GPU entry points run on the card by default and raise
    without one, before they start a group or read a mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from sift3d_tpu_torch.parallel import init_distributed, make_mesh
    from sift3d_tpu_torch.register.groupwise import (
        groupwise_solve_sharded, register_groupwise_sharded)
    vols = np.zeros((1, 16, 16, 16), np.float32)
    pts = np.zeros((1, 8, 3))
    calls = {
        "init_distributed": lambda: init_distributed(),
        "make_mesh": lambda: make_mesh(),
        "batch_detect_describe": lambda: tpipe.batch_detect_describe(
            vols, None, SIFT3DParams(), mesh=_cpu_mesh()),
        "batch_register_pairs": lambda: tpipe.batch_register_pairs(
            vols, vols, None, SIFT3DParams(), mesh=_cpu_mesh()),
        "groupwise_solve_sharded": lambda: groupwise_solve_sharded(
            np.array([(0, 1)]), pts, pts, np.array([8]), 2, _cpu_mesh()),
        "register_groupwise_sharded": lambda: register_groupwise_sharded(
            _gw_desc(), np.array([(0, 1)]), (1.0, 1.0, 1.0), _cpu_mesh()),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_mesh_entry_points_run_on_cpu_when_asked():
    """With ``device="cpu"``: ``init_distributed`` starts no group for one
    process, ``make_mesh`` makes a one-rank gloo group, and the meshed
    entry points run on it."""
    import torch.distributed as dist
    from sift3d_tpu_torch import pyramid as tpyr
    from sift3d_tpu_torch.parallel import init_distributed, make_mesh
    from sift3d_tpu_torch.register.groupwise import (
        groupwise_solve_sharded, register_groupwise_sharded)
    assert init_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    m = make_mesh(device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert (m.data, m.space, m.d, m.s) == (1, 1, 0, 0)
        vols = np.zeros((2, 16, 16, 16), np.float32)
        params = SIFT3DParams()
        plan = tpyr.plan_pyramid((16, 16, 16), (1.0, 1.0, 1.0), params)
        res = tpipe.batch_register_pairs(vols, vols, plan, params,
                                         device="cpu", mesh=m)
        assert res.A.shape == (2, 3, 4) and not res.ok.any()
        with pytest.raises(ValueError, match="mesh"):
            tpipe.batch_detect_describe(vols, plan, params, device="cpu",
                                        mesh=dataclasses.replace(
                                            m, device=torch.device("meta")))
        edges = np.array([(0, 1)])
        pts = np.zeros((1, 8, 3))
        assert groupwise_solve_sharded(edges, pts, pts, np.array([8]), 2, m,
                                       device="cpu").A.shape == (2, 3, 4)
        assert register_groupwise_sharded(
            _gw_desc(), edges, (1.0, 1.0, 1.0), m,
            device="cpu").A.device.type == "cpu"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cli,argv", [
    ("kp", ["--keys", "k.csv", "missing.nii"]),
    ("reg", ["--transform", "t.csv", "missing.nii", "missing.nii"]),
    ("reg", ["--type=tps", "--transform", "t.csv", "missing.nii",
             "missing.nii"]),
    ("dense", ["missing.nii", "out%.nii"]),
])
def test_cli_refuses_cpu_fallback(cli, argv, tmp_path):
    """Without a card a CLI's ``main`` raises before it reads anything,
    unless the caller names a device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib
    from sift3d_tpu_torch.io import FileDoesNotExistError
    main = importlib.import_module(f"sift3d_tpu_torch.cli.{cli}").main
    argv = [a if a.startswith("--") else str(tmp_path / a) for a in argv]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    with pytest.raises(FileDoesNotExistError):
        main(argv, device="cpu")


def test_entry_points_pin_full_fp32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    Sift3D(device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _launch_counters() -> dict:
    return {k: v for k, v in trace.counters().items()
            if k.startswith("launches.")}


def test_wrappers_run_plain_on_cpu_without_counting():
    before = _launch_counters()
    level = torch.zeros((12, 12, 12))
    out = cuda_window.descrip_window(
        level, torch.full((2, 3), 6.0), torch.eye(3).expand(2, 3, 3), 1,
        (3, 3, 3), (8, 8, 8), (1.0, 1.0, 1.0), 1.0, 2.0)
    assert out.shape == (2, 768) and not out.any()
    q = torch.ones((3, 768))
    best, _, idx = cuda_match.reduce_one_way(q, q, q.sum(1), q.sum(1))
    assert idx.tolist() == [0, 0, 0] and (best == 0).all()
    A6, vd = cuda_orient.orient_terms(
        torch.zeros((2, 12, 12, 12)), torch.full((3, 3), 6), 2, (3, 3, 3),
        (7, 7, 7), (1.0, 1.0, 1.0), 1.0, 3.0, vol=torch.tensor([0, 1, 1]))
    assert A6.dtype == torch.float64 and A6.shape == (3, 6)
    assert vd.shape == (3, 3) and not A6.any() and not vd.any()
    flat = torch.zeros((2, 6, 6, 6))
    count, total, emit = cuda_extrema.scan([(flat, flat, flat, 4)], 0.1)
    assert count.tolist() == total.tolist() == [[0, 0]]
    assert emit(0).shape == (0, 4)
    assert _launch_counters() == before


@pytest.mark.parametrize("cls,kw", [
    (SIFT3DParams, dict(peak_thresh=0.05, max_kp_per_octave=[192, 64])),
    (MatchParams, dict(nn_thresh=0.7, impl="streamed")),
    (RansacParams, dict(num_iter=50, seed=3)),
])
def test_params_from_dict(cls, kw):
    p = params_from_dict(cls, kw)
    assert isinstance(p, cls)
    for k, v in kw.items():
        assert getattr(p, k) == (tuple(v) if isinstance(v, list) else v)
    with pytest.raises(ValueError):
        params_from_dict(cls, dict(kw, bogus=1))


@pytest.mark.parametrize("name,default,other", [
    ("fused_bucket_cap", 512, 64),
])
def test_params_from_dict_jax_only_fields(name, default, other):
    p = params_from_dict(SIFT3DParams, {"peak_thresh": 0.05, name: default})
    assert p == SIFT3DParams(peak_thresh=0.05)
    assert not hasattr(p, name)
    with pytest.raises(ValueError, match=name):
        params_from_dict(SIFT3DParams, {name: other})


@pytest.mark.parametrize("value", [False, True])
def test_params_from_dict_carries_dense_rotate(value):
    p = params_from_dict(SIFT3DParams, {"peak_thresh": 0.05,
                                        "dense_rotate": value})
    assert p == SIFT3DParams(peak_thresh=0.05, dense_rotate=value)


def test_small_volume_rejected():
    with pytest.raises(ValueError, match="too small"):
        Sift3D(device="cpu").detect(np.zeros((6, 16, 16), np.float32))
