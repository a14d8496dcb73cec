"""Port parity: the kpSift3D, regSift3D and denseSift3D command lines.

The port's CLIs (``python -m sift3d_tpu_torch.cli.kp`` / ``.reg`` /
``.dense``) run with ``device="cpu"`` beside the JAX package's on the same
NIfTI files: a 32^3 volume for kp and dense, a 40^3 pair (the second
rolled by (1, -2, 2)) for reg. Keypoint CSV values agree within 1e-6 (each
printed to 6 decimals, so the text may differ by one unit of the last),
descriptors within 2e-3, match rows exactly, the transform within the
5e-2 / 5-voxel contract of the JAX package's (RANSAC draws differ), the
port's warp of the JAX package's affine within 1e-5 of its warped file,
and the drawn images exactly. ``denseSift3D`` writes 12 channel images
within 2e-3 of the JAX CLI's. ``regSift3D --type tps`` on a 32^3 pair
rolled by 2 along x, with the JAX package's RANSAC draws replayed, writes
the JAX CLI's TPS CSV within 1e-6 and its warped image within 1e-5 of the
volume's largest value; it refuses ``--resample`` as the JAX CLI does.
Options, defaults and choices are those of the JAX CLIs.
"""

import argparse

import numpy as np
import pytest
import torch

from sift3d_tpu.api import RegSift3D as JRegSift3D
from sift3d_tpu.cli import dense as jdense
from sift3d_tpu.cli import kp as jkp
from sift3d_tpu.cli import reg as jreg
from sift3d_tpu.io import Volume as JVolume
from sift3d_tpu.io import im_write as jim_write

from sift3d_tpu_torch.api import warp
from sift3d_tpu_torch.cli import dense as pdense
from sift3d_tpu_torch.cli import kp as pkp
from sift3d_tpu_torch.cli import reg as preg
from sift3d_tpu_torch.io import im_read
from sift3d_tpu_torch.io.csv import read_descriptors, read_mat, read_tps
from sift3d_tpu_torch.register import ransac as pransac

from tests.conftest import make_blob_volume
from tests.test_torch_register import jax_draws

torch.set_num_threads(1)

KP_OUT = {"--keys": "keys.csv", "--desc": "desc.csv.gz", "--draw": "draw.nii"}
REG_OUT = {"--matches": "m.csv", "--transform": "t.csv",
           "--warped": "w.nii.gz", "--concat": "c.nii", "--keys": "k.nii",
           "--lines": "l.nii"}


def _args(outs, d):
    return [a for flag, name in outs.items() for a in (flag, str(d / name))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' CLIs on the same inputs, each into its own
    directory; the JAX package's full-precision affine of the pair."""
    root = tmp_path_factory.mktemp("cli")
    img = root / "img.nii"
    jim_write(str(img), JVolume(make_blob_volume((32, 32, 32), seed=5)))
    pair = make_blob_volume((40, 40, 40), seed=6)
    src, ref = root / "src.nii", root / "ref.nii"
    jim_write(str(src), JVolume(pair))
    jim_write(str(ref), JVolume(np.roll(pair, (1, -2, 2), axis=(0, 1, 2))))
    out = {}
    for name, kp_main, reg_main, kw in (
            ("jax", jkp.main, jreg.main, {}),
            ("port", pkp.main, preg.main, {"device": "cpu"})):
        d = root / name
        d.mkdir()
        assert kp_main(_args(KP_OUT, d) + [str(img)], **kw) == 0
        assert reg_main(_args(REG_OUT, d) + [str(src), str(ref)], **kw) == 0
        out[name] = d
    A = JRegSift3D().register(im_read(str(src)).data,
                              im_read(str(ref)).data).A
    return out, src, ref, np.asarray(A)


def test_kp_outputs_match_jax(runs):
    d = runs[0]
    k_j, k_p = (read_mat(str(d[n] / "keys.csv")) for n in ("jax", "port"))
    assert k_p.shape == k_j.shape and k_p.shape[1] == 14 and len(k_p) > 3
    np.testing.assert_allclose(k_p, k_j, rtol=0, atol=2e-6)
    d_j, d_p = (read_descriptors(str(d[n] / "desc.csv.gz"))
                for n in ("jax", "port"))
    assert d_p.shape == d_j.shape == (len(k_p), 771)
    np.testing.assert_allclose(d_p[:, :3], d_j[:, :3], rtol=0, atol=2e-6)
    assert np.abs(d_p[:, 3:] - d_j[:, 3:]).max() <= 2e-3
    np.testing.assert_array_equal(im_read(str(d["port"] / "draw.nii")).data,
                                  im_read(str(d["jax"] / "draw.nii")).data)


def test_reg_outputs_match_jax(runs):
    d, src, ref, A_full = runs
    m_j, m_p = (read_mat(str(d[n] / "m.csv")) for n in ("jax", "port"))
    assert m_p.shape[1] == 6 and len(m_p) > 3
    np.testing.assert_array_equal(m_p, m_j)
    A_j, A_p = (read_mat(str(d[n] / "t.csv")) for n in ("jax", "port"))
    assert A_p.shape == (3, 4)
    np.testing.assert_allclose(A_p[:, :3], A_j[:, :3], rtol=0, atol=5e-2)
    np.testing.assert_allclose(A_p[:, 3], A_j[:, 3], rtol=0, atol=5.0)
    np.testing.assert_allclose(A_full, A_j, rtol=0, atol=1e-6)
    w_j = im_read(str(d["jax"] / "w.nii.gz")).data
    w_p = im_read(str(d["port"] / "w.nii.gz")).data
    assert w_p.shape == w_j.shape == (40, 40, 40)
    got = warp(im_read(str(src)), A_full, out_shape_zyx=w_j.shape,
               device="cpu")
    assert np.abs(got - w_j).max() <= 1e-5
    for name in ("c.nii", "k.nii", "l.nii"):
        np.testing.assert_array_equal(im_read(str(d["port"] / name)).data,
                                      im_read(str(d["jax"] / name)).data)


def _parser(main, monkeypatch):
    """The argparse parser a CLI's ``main`` builds."""
    class Built(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Built(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Built) as e:
        main([])
    monkeypatch.undo()
    return e.value.args[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, type(a).__name__) for a in parser._actions}


@pytest.mark.parametrize("port_main,jax_main", [(pkp.main, jkp.main),
                                                (preg.main, jreg.main),
                                                (pdense.main, jdense.main)])
def test_options_and_defaults_equal(port_main, jax_main, monkeypatch):
    got = _parser(port_main, monkeypatch)
    want = _parser(jax_main, monkeypatch)
    assert got.prog == want.prog
    assert _options(got) == _options(want)


def test_tps_resample_is_refused(tmp_path):
    """``--type tps --resample`` exits with an error and writes nothing,
    as the JAX CLI does."""
    vol = make_blob_volume((16, 16, 16), seed=1)
    src = str(tmp_path / "s.nii")
    jim_write(src, JVolume(vol))
    for main, kw in ((preg.main, {"device": "cpu"}), (jreg.main, {})):
        with pytest.raises(SystemExit) as e:
            main(["--type", "tps", "--resample", "--transform",
                  str(tmp_path / "t.csv"), src, src], **kw)
        assert e.value.code == 2
        assert not (tmp_path / "t.csv").exists()


@pytest.mark.parametrize("main", [pkp.main, preg.main])
def test_no_outputs_is_an_error(main):
    with pytest.raises(SystemExit) as e:
        main(["a.nii", "b.nii"][:1 + (main is preg.main)], device="cpu")
    assert e.value.code != 0


def test_dense_needs_the_marker(tmp_path):
    with pytest.raises(SystemExit) as e:
        pdense.main(["a.nii", str(tmp_path / "out.nii")], device="cpu")
    assert e.value.code == 2


@pytest.fixture(scope="module")
def dense_tps_runs(tmp_path_factory):
    """Both packages' denseSift3D on a 32^3 image and regSift3D --type tps
    on a 32^3 pair, the port's RANSAC on the JAX package's draws."""
    root = tmp_path_factory.mktemp("cli_dense_tps")
    img = root / "img.nii"
    jim_write(str(img), JVolume(make_blob_volume((32, 32, 32), seed=5)))
    pair = make_blob_volume((32, 32, 32), seed=23)
    src, ref = root / "src.nii", root / "ref.nii"
    jim_write(str(src), JVolume(pair))
    jim_write(str(ref), JVolume(np.roll(pair, 2, axis=2)))

    def replayed(count, params, device=None):
        n = int(torch.as_tensor(count).reshape(-1)[0])
        return torch.as_tensor(jax_draws(params, n), device=device)[None]
    out = {}
    for name, dense_main, reg_main, kw in (
            ("jax", jdense.main, jreg.main, {}),
            ("port", pdense.main, preg.main, {"device": "cpu"})):
        d = root / name
        d.mkdir()
        assert dense_main([str(img), str(d / "ch%.nii")], **kw) == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pransac, "draw_indices", replayed)
            assert reg_main(["--type", "tps", "--transform", str(d / "t.csv"),
                             "--warped", str(d / "w.nii"), str(src),
                             str(ref)], **kw) == 0
        out[name] = d
    return out, pair


def test_dense_cli_matches_jax(dense_tps_runs):
    d, _ = dense_tps_runs
    for c in range(12):
        got = im_read(str(d["port"] / f"ch{c}.nii")).data
        want = im_read(str(d["jax"] / f"ch{c}.nii")).data
        assert got.shape == want.shape == (32, 32, 32)
        assert np.abs(got - want).max() <= 2e-3
    assert not (d["port"] / "ch12.nii").exists()


def test_tps_cli_matches_jax(dense_tps_runs):
    d, pair = dense_tps_runs
    p_j, c_j = read_tps(str(d["jax"] / "t.csv"))
    p_p, c_p = read_tps(str(d["port"] / "t.csv"))
    assert p_p.shape == p_j.shape == (3, len(c_j) + 4) and len(c_j) >= 5
    np.testing.assert_allclose(c_p, c_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p_p, p_j, rtol=0, atol=1e-6)
    w_j = im_read(str(d["jax"] / "w.nii")).data
    w_p = im_read(str(d["port"] / "w.nii")).data
    assert w_p.shape == w_j.shape == (32, 32, 32)
    assert np.abs(w_p - w_j).max() <= 1e-5 * np.abs(pair).max()
