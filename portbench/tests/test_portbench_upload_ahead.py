"""The reader of ``upload_ahead_pct.pairs`` against a synthetic counter
set, in the style of ``test_portbench_spans.py``'s counter readers: None
where there is nothing to read (a program without the counters
included)."""

import sys
import types

import pytest

from portbench import counters, spec

CELL = "mni152.batch64"
STACK = 64 * 182 * 218 * 182 * 4
COUNTS = {counters.CALLS: 4, "upload.bytes": 4 * 2 * STACK,
          "upload.ahead_bytes": 4 * STACK}


def _reader():
    return spec.load_module(
        spec.resolve(CELL).reader_files["upload_ahead_pct.pairs"])


def test_upload_ahead_reader(monkeypatch):
    r = _reader()
    assert r.value(COUNTS) == pytest.approx(50.0)
    assert r.value({}) is None
    assert r.value({k: v for k, v in COUNTS.items()
                    if k != counters.CALLS}) is None
    # A port without the upload counters reads nothing; one that uploads
    # nothing ahead reads 0.
    assert r.value({counters.CALLS: 4}) is None
    assert r.value({counters.CALLS: 4, "upload.bytes": 8}) == 0.0
    # read() takes the port's own counters in this process ...
    from sift3d_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "_counters", dict(COUNTS))
    assert r.read({}) == pytest.approx(50.0)
    monkeypatch.setattr(trace, "_counters", {})
    assert r.read({}) is None
    # ... and reads nothing from a port that keeps no counters.
    monkeypatch.setitem(sys.modules, "sift3d_tpu_torch.utils.trace",
                        types.ModuleType("sift3d_tpu_torch.utils.trace"))
    assert r.read({}) is None
