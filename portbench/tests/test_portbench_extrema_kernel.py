"""The reader of ``extrema_kernel_pct.pairs`` against a synthetic counter
set, in the style of ``test_portbench_upload_ahead.py``: 100 where the
kernels found every level, None where there is nothing to read (a
program without the counters included)."""

import sys
import types

import pytest

from portbench import counters, spec

CELL = "mni152.batch64"
# Two calls, two sides a call, 15 keypoint levels a side.
COUNTS = {counters.CALLS: 2, "extrema.levels": 2 * 2 * 15,
          "extrema.kernel_levels": 2 * 2 * 15}


def _reader():
    return spec.load_module(
        spec.resolve(CELL).reader_files["extrema_kernel_pct.pairs"])


def test_extrema_kernel_reader(monkeypatch):
    r = _reader()
    assert r.value(COUNTS) == pytest.approx(100.0)
    assert r.value({}) is None
    assert r.value({k: v for k, v in COUNTS.items()
                    if k != counters.CALLS}) is None
    # A port that counts no level (the parent) reads nothing; levels that
    # the plain version alone found read 0.
    assert r.value({counters.CALLS: 2}) is None
    assert r.value({counters.CALLS: 2, "extrema.rows": 9}) is None
    assert r.value({counters.CALLS: 2, "extrema.levels": 60}) == 0.0
    assert r.value(dict(COUNTS, **{"extrema.kernel_levels": 30})) == \
        pytest.approx(50.0)
    # read() takes the port's own counters in this process ...
    from sift3d_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "_counters", dict(COUNTS))
    assert r.read({}) == pytest.approx(100.0)
    monkeypatch.setattr(trace, "_counters", {})
    assert r.read({}) is None
    # ... and reads nothing from a port that keeps no counters.
    monkeypatch.setitem(sys.modules, "sift3d_tpu_torch.utils.trace",
                        types.ModuleType("sift3d_tpu_torch.utils.trace"))
    assert r.read({}) is None
