"""The readers of the port's spans and counters (``metrics/``), against a
synthetic summary and a synthetic counter set, None where there is
nothing to read (a program without the spans or counters included); and
on the card, that the counted host reads are every sync of a call."""

import collections
import contextlib
import sys
import traceback
import types
import warnings

import pytest
import torch

from portbench import counters, spec

CELL = "mni152.batch64"
SYNC = "called a synchronizing CUDA operation"
SPAN_READERS = {
    "upload_host_ms.pairs": 300.0 / 2,
    "sync_wait_ms.pairs": (250.0 + 6.0 + 4.0) / 2,
    "extrema_busy_ms.pairs": (200.0 + 70.0) / 2,
    "orientation_busy_ms.pairs": (3.0 + 1.0) / 2,
    "match_busy_ms.pairs": 20.0 / 2,
    "ransac_busy_ms.pairs": 40.0 / 2,
}
COUNTS = {"calls.batch_register_pairs": 4, "conv.w_uploads": 624,
          "sync.extrema": 120, "sync.orientation": 8,
          "sync.descriptors": 16, "extrema.rows": 40000,
          "orientation.kept": 10000}
COUNTER_READERS = {"host_syncs.pairs": 36.0, "conv_w_uploads.pairs": 156.0,
                   "orient_kept_pct.pairs": 25.0}


def _reader(name):
    return spec.load_module(spec.resolve(CELL).reader_files[name])


def _summary():
    return dict(
        requests=2,
        span_host_ms={"sift3d.upload": 300.0, "sift3d.pyramid": 10.0,
                      "sift3d.extrema": 400.0, "sift3d.sync.extrema": 250.0,
                      "sift3d.sync.orientation": 6.0,
                      "sift3d.sync.descriptors": 4.0},
        span_busy_ms={"sift3d.extrema": 200.0, "sift3d.sync.extrema": 70.0,
                      "sift3d.orientation": 3.0,
                      "sift3d.sync.orientation": 1.0, "sift3d.match": 20.0,
                      "sift3d.ransac": 40.0, "sift3d.pyramid": 450.0})


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader(name):
    r = _reader(name)
    assert r.read(_summary()) == pytest.approx(SPAN_READERS[name])
    assert r.read({}) is None
    assert r.read(dict(requests=2, span_host_ms={}, span_busy_ms={})) is None


@pytest.mark.parametrize("name", sorted(COUNTER_READERS))
def test_counter_reader(name, monkeypatch):
    r = _reader(name)
    assert r.value(COUNTS) == pytest.approx(COUNTER_READERS[name])
    assert r.value({}) is None
    assert r.value({k: v for k, v in COUNTS.items()
                    if k != counters.CALLS}) is None
    # read() takes the port's own counters in this process ...
    from sift3d_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "_counters", dict(COUNTS))
    assert r.read({}) == pytest.approx(COUNTER_READERS[name])
    monkeypatch.setattr(trace, "_counters", {})
    assert r.read({}) is None
    # ... and reads nothing from a port that keeps no counters.
    monkeypatch.setitem(sys.modules, "sift3d_tpu_torch.utils.trace",
                        types.ModuleType("sift3d_tpu_torch.utils.trace"))
    assert r.read({}) is None


def test_kept_share_needs_rows():
    r = _reader("orient_kept_pct.pairs")
    assert r.value({counters.CALLS: 1, "orientation.kept": 0}) is None
    assert r.value({counters.CALLS: 1, "orientation.kept": 0,
                    "extrema.rows": 5}) == 0.0


def _port_line() -> str:
    """The innermost line of the port on the stack (the last frames where
    the port is not on it)."""
    stack = traceback.extract_stack()[:-2]
    port = [f for f in stack if "sift3d_tpu_torch" in f.filename]
    if not port:
        return "outside the port: " + " < ".join(
            f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
            for f in reversed(stack[-6:]))
    f = port[-1]
    return f"{f.filename.split('sift3d_tpu_torch')[-1]}:{f.lineno} {f.name}"


def test_counted_reads_are_every_sync(cuda, monkeypatch, tmp_path):
    """One pool item of 16 pairs at the cell's grid: every sync that
    ``set_sync_debug_mode("warn")`` reports in one call is either a
    blocking copy from the host (as many as the trace's host-to-device
    copies) or the one sync of a ``trace.host_read``, and those are the
    call's ``sync.*`` counters."""
    from portbench import trace_read
    from sift3d_tpu_torch.utils import trace
    cell = spec.resolve(CELL)
    cell.traffic = dict(cell.traffic, pool=1, pairs_per_request=16)
    entry = spec.load_module(cell.entry_file).Entry(cell, cuda)
    entry.make_pool(2 ** 31 + 77)
    entry.request(0)                       # builds, tables and caches
    torch.cuda.synchronize()
    seen = []
    depth = [0]
    host_read = trace.host_read

    @contextlib.contextmanager
    def marked(stage):
        with host_read(stage):
            depth[0] += 1
            try:
                yield
            finally:
                depth[0] -= 1

    def hook(message, category, filename, lineno, file=None, line=None):
        # Each sync's warning (the mode's one-time notice is left out).
        if SYNC in str(message):
            seen.append((depth[0] > 0, _port_line()))

    monkeypatch.setattr(trace, "host_read", marked)
    before = trace.counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                entry.request(0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    after = trace.counters()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    copies = collections.Counter(
        e["name"].split(" ")[1] for e in
        trace_read.load_events(tmp_path / "trace.json")
        if e.get("cat") == "gpu_memcpy")
    reads = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("sync.")}
    inside = sum(1 for r, _ in seen if r)
    print(f"sync warnings {len(seen)}, {inside} in host reads; copies "
          f"{dict(copies)}; counted reads {reads}")
    for (r, where), n in sorted(collections.Counter(seen).items()):
        print(f"  {n:4d} {'read ' if r else 'other'} {where}")
    assert inside == sum(reads.values())
    assert len(seen) - copies["HtoD"] == sum(reads.values())
