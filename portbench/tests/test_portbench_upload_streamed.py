"""The reader of ``upload_streamed_pct.pairs`` against a synthetic counter
set, in the style of ``test_portbench_upload_ahead.py``: None where there
is nothing to read (a program without the counter included)."""

import sys
import types

import pytest

from portbench import counters, spec

CELL = "mni152.batch64"
STACK = 64 * 182 * 218 * 182 * 4
# Each side streamed in 4 sub-batches of 18, 18, 18 and 10 volumes: all
# but the first 18 volumes of each stack land after its pyramid began.
STREAMED = 4 * 2 * STACK * 46 // 64
COUNTS = {counters.CALLS: 4, "upload.bytes": 4 * 2 * STACK,
          "upload.ahead_bytes": 4 * STACK,
          "upload.streamed_bytes": STREAMED}


def _reader():
    return spec.load_module(
        spec.resolve(CELL).reader_files["upload_streamed_pct.pairs"])


def test_upload_streamed_reader(monkeypatch):
    r = _reader()
    assert r.value(COUNTS) == pytest.approx(100 * 46 / 64)
    assert r.value({}) is None
    assert r.value({k: v for k, v in COUNTS.items()
                    if k != counters.CALLS}) is None
    # A port without the streamed counter reads nothing, however much it
    # uploads; one that streams nothing reads 0.
    assert r.value({k: v for k, v in COUNTS.items()
                    if k != "upload.streamed_bytes"}) is None
    assert r.value({counters.CALLS: 4, "upload.streamed_bytes": 0}) is None
    assert r.value({counters.CALLS: 4, "upload.bytes": 8,
                    "upload.streamed_bytes": 0}) == 0.0
    # read() takes the port's own counters in this process ...
    from sift3d_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "_counters", dict(COUNTS))
    assert r.read({}) == pytest.approx(100 * 46 / 64)
    monkeypatch.setattr(trace, "_counters", {})
    assert r.read({}) is None
    # ... and reads nothing from a port that keeps no counters.
    monkeypatch.setitem(sys.modules, "sift3d_tpu_torch.utils.trace",
                        types.ModuleType("sift3d_tpu_torch.utils.trace"))
    assert r.read({}) is None
