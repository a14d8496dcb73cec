"""Port parity: file I/O.

The port keeps its own copy of the JAX package's host I/O
(``sift3d_tpu_torch/io``): NIfTI (.nii, .nii.gz, ANALYZE .img pairs) and
CSV written by either package read back equal through the other, CSV
text is byte-equal, and .nii.gz files are equal after decompression (the
gzip header holds a time). DICOM goes through the port's copy of the
native codec, built into its own library, where g++ builds it.
"""

import gzip
import struct

import numpy as np
import pytest

from sift3d_tpu import io as jio
from sift3d_tpu.io import csv as jcsv
from sift3d_tpu.io import dicom as jdicom

from sift3d_tpu_torch import io as pio
from sift3d_tpu_torch.io import csv as pcsv
from sift3d_tpu_torch.io import dicom as pdicom

PACKAGES = {"jax": jio, "port": pio}
DICOM = {"jax": jdicom, "port": pdicom}


def _volume(kind, rng):
    if kind == "3d":
        return rng.random((9, 7, 11)).astype(np.float32), (1.5, 2.0, 0.5)
    if kind == "4d":
        return rng.random((6, 5, 4, 3)).astype(np.float32), (1.0, 1.0, 1.0)
    return rng.random((1, 8, 9)).astype(np.float32), (0.5, 0.5, 3.0)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["3d", "4d", "2d"])
@pytest.mark.parametrize("ext", [".nii", ".nii.gz", ".img"])
def test_nifti_written_by_one_read_by_other(tmp_path, writer, reader, kind,
                                            ext):
    rng = np.random.default_rng(1)
    data, units = _volume(kind, rng)
    path = str(tmp_path / f"v{ext}")
    PACKAGES[writer].im_write(path, PACKAGES[writer].Volume(data, units))
    back = PACKAGES[reader].im_read(path)
    assert back.units == units
    np.testing.assert_array_equal(back.data, data)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_nifti_bytes_equal(tmp_path, ext):
    rng = np.random.default_rng(2)
    data, units = _volume("4d", rng)
    paths = []
    for name, pkg in PACKAGES.items():
        paths.append(tmp_path / f"{name}{ext}")
        pkg.im_write(str(paths[-1]), pkg.Volume(data, units))
    blobs = [p.read_bytes() for p in paths]
    if ext == ".nii.gz":
        blobs = [gzip.decompress(b) for b in blobs]
    assert blobs[0] == blobs[1]


def test_nifti_scl_slope_read_equal(tmp_path):
    """An int16 file with slope and intercept (nifti.c:100-111)."""
    nx, ny, nz = 4, 3, 2
    data = np.arange(nx * ny * nz, dtype=np.int16)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 4)
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 1, 2.0, 3.0, 4.0, 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 2.5)
    struct.pack_into("<f", hdr, 116, -1.0)
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")
    path = str(tmp_path / "s.nii")
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4 + data.tobytes())
    got, want = pio.im_read(path), jio.im_read(path)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.units == want.units == (2.0, 3.0, 4.0)
    np.testing.assert_allclose(
        got.data, (data.reshape(nz, ny, nx) * 2.5 - 1.0).astype(np.float32))


def _csv_writes(pkg, d, rng_seed):
    """Every CSV writer of one package into directory ``d``."""
    rng = np.random.default_rng(rng_seed)
    pkg.write_mat(str(d / "m.csv"), rng.random((5, 4)) * 100 - 50)
    pkg.write_keypoints(str(d / "k.csv"), rng.random((7, 14)))
    pkg.write_descriptors(str(d / "d.csv.gz"),
                          rng.random((3, 771)).astype(np.float32))
    pkg.write_affine(str(d / "a.csv"), rng.random((3, 4)))
    pkg.write_matches(str(d / "x.csv"), rng.random((4, 3)),
                      rng.random((4, 3)))


def test_csv_text_equal_and_read_by_other(tmp_path):
    dirs = {}
    for name, pkg in (("jax", jcsv), ("port", pcsv)):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _csv_writes(pkg, dirs[name], 3)
    for f in ("m.csv", "k.csv", "a.csv", "x.csv"):
        assert (dirs["jax"] / f).read_bytes() == \
            (dirs["port"] / f).read_bytes()
    with gzip.open(dirs["jax"] / "d.csv.gz", "rb") as a, \
            gzip.open(dirs["port"] / "d.csv.gz", "rb") as b:
        assert a.read() == b.read()
    for f in ("m.csv", "k.csv", "a.csv", "x.csv"):
        np.testing.assert_array_equal(pcsv.read_mat(str(dirs["jax"] / f)),
                                      jcsv.read_mat(str(dirs["port"] / f)))
    np.testing.assert_array_equal(
        pcsv.read_descriptors(str(dirs["jax"] / "d.csv.gz")),
        jcsv.read_descriptors(str(dirs["port"] / "d.csv.gz")))


def test_io_errors(tmp_path):
    with pytest.raises(pio.FileDoesNotExistError):
        pio.im_read(str(tmp_path / "missing.nii"))
    with pytest.raises(pio.UnsupportedFileTypeError):
        pio.im_write(str(tmp_path / "bad.xyz"),
                     pio.Volume(np.zeros((2, 2, 2), np.float32)))
    with pytest.raises(ValueError):
        pio.Volume(np.zeros((2, 2, 2), np.float32), units=(0, 1, 1))
    with pytest.raises(ValueError):
        pcsv.write_affine(str(tmp_path / "a.csv"), np.zeros((4, 4)))


@pytest.fixture()
def codec():
    try:
        pdicom._get_lib()
    except pio.WrapperNotCompiledError as e:
        pytest.skip(f"the DICOM codec does not build here: {e}")
    return pdicom


@pytest.fixture(scope="session")
def jax_codec_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_dicom_build")


@pytest.fixture()
def jax_codec(jax_codec_dir, monkeypatch):
    """The JAX codec, built into a directory of this test session.

    Its own build runs ``g++ -o`` straight onto one library shared by every
    process (``$TMPDIR/sift3d_native``): a test worker that loads it while
    another is linking it reads a truncated file, stores the error and
    raises on every later call. A private directory has no other writer.
    """
    monkeypatch.setattr(jdicom, "_BUILD", jax_codec_dir)
    monkeypatch.setattr(jdicom, "_lib", None)
    monkeypatch.setattr(jdicom, "_build_error", None)
    return jdicom


def test_dicom_codec_builds_its_own_library(codec):
    assert codec._BUILD != jdicom._BUILD
    assert "build/native" in str(codec._BUILD)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("target", ["a.dcm", "series"])
def test_dicom_round_trip(tmp_path, codec, jax_codec, writer, reader, target):
    rng = np.random.default_rng(4)
    vol = rng.random((5, 6, 7)).astype(np.float32)
    path = str(tmp_path / target)
    v = PACKAGES[writer].Volume(vol, (1.5, 2.0, 0.5))
    if target == "series":
        DICOM[writer].write_dcm_dir(path, v)
    else:
        PACKAGES[writer].im_write(path, v)
    back = PACKAGES[reader].im_read(path)
    assert back.data.shape == vol.shape
    np.testing.assert_allclose(back.units, (1.5, 2.0, 0.5), atol=1e-6)
    # The writer quantizes to 8 bits: stored = trunc(v * 255 / max).
    m = float(vol.max())
    np.testing.assert_allclose(back.data * (m / 255.0), vol,
                               atol=m / 255.0 + 1e-6)
    if writer != reader:
        np.testing.assert_array_equal(back.data,
                                      PACKAGES[writer].im_read(path).data)
