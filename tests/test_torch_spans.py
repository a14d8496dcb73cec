"""The port's spans and counters (``sift3d_tpu_torch/utils/trace.py``) on
the batched config-4 path, ``batch_register_pairs`` on 2 pairs of 24^3
blob volumes on the CPU.

Under ``torch.profiler``: ``sift3d.upload`` opens before
``sift3d.pyramid`` and beside it, no ``sift3d.*`` span opens inside the
pyramid or around the whole call, each ``sift3d.sync.<stage>`` lies in
its ``sift3d.<stage>``, and the sync spans are as many as the ``sync.*``
counters. ``conv.w_uploads`` is one copy of every blur's operators the
first time (the device cache starts empty) and none the second, and the
counters count the same with the profiler off.
"""

import collections
import json

import pytest
import torch

from benches.data import make_pairs
from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import RansacParams, SIFT3DParams
from sift3d_tpu_torch.features.detect import kp_levels
from sift3d_tpu_torch.ops import conv
from sift3d_tpu_torch.parallel.pipeline import batch_register_pairs
from sift3d_tpu_torch.utils import trace

torch.set_num_threads(1)

SHAPE = (24, 24, 24)
STAGES = {"sift3d.upload", "sift3d.pyramid", "sift3d.extrema",
          "sift3d.orientation", "sift3d.descriptors", "sift3d.match",
          "sift3d.ransac"}


def _call(src, ref, plan, params) -> dict:
    """The counters that one call adds."""
    before = trace.counters()
    batch_register_pairs(src, ref, plan, params,
                         ransac_params=RansacParams(num_iter=50),
                         device="cpu")
    after = trace.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    src, ref = make_pairs(2, SHAPE, nblob=40)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(SHAPE[::-1], (1.0, 1.0, 1.0), params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "_device_ops", {})
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = _call(src, ref, plan, params)
        untraced = _call(src, ref, plan, params)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and
                       e.get("cat") == "user_annotation" and
                       e["name"].startswith("sift3d."))
    return dict(plan=plan, spans=spans, traced=traced, untraced=untraced)


def _inside(a, b) -> bool:
    """Span ``a`` lies within span ``b`` (and is not ``b``)."""
    return a is not b and b[0] <= a[0] and a[1] <= b[1]


def _parent(span, spans):
    """The innermost ``sift3d.*`` span around ``span``, or None."""
    outer = [s for s in spans if _inside(span, s)]
    return max(outer) if outer else None


def _upload_before_pyramid(r):
    spans = r["spans"]
    uploads = [s for s in spans if s[2] == "sift3d.upload"]
    pyramids = [s for s in spans if s[2] == "sift3d.pyramid"]
    assert len(uploads) == len(pyramids) == 2          # one a side
    for u, p in zip(uploads, pyramids):
        assert u[1] <= p[0]
        assert not _inside(u, p) and _parent(u, spans) is None


def _nothing_in_pyramid(r):
    spans = r["spans"]
    for p in (s for s in spans if s[2] == "sift3d.pyramid"):
        assert not [s for s in spans if _inside(s, p)]


def _no_root_span(r):
    spans = r["spans"]
    top = {s[2] for s in spans if _parent(s, spans) is None}
    assert top == STAGES


def _sync_inside_stage(r):
    spans = r["spans"]
    syncs = [s for s in spans if s[2].startswith("sift3d.sync.")]
    assert {s[2] for s in syncs} == {"sift3d.sync.extrema",
                                     "sift3d.sync.orientation",
                                     "sift3d.sync.descriptors"}
    for s in syncs:
        stage = s[2].rsplit(".", 1)[1]
        assert _parent(s, spans)[2] == f"sift3d.{stage}"


def _at_most_32_nested(r):
    spans = r["spans"]
    for st in (s for s in spans if s[2] in STAGES):
        assert len([s for s in spans if _inside(s, st)]) <= 32


def _sync_spans_equal_counters(r):
    spans = collections.Counter(s[2] for s in r["spans"]
                                if s[2].startswith("sift3d.sync."))
    counted = {f"sift3d.{k}": v for k, v in r["traced"].items()
               if k.startswith("sync.")}
    assert dict(spans) == counted
    # A side reads once for the extrema of every keypoint level and once
    # for orientation's keep.
    assert counted["sift3d.sync.extrema"] == 2
    assert counted["sift3d.sync.orientation"] == 2
    assert r["traced"]["extrema.levels"] == 2 * len(kp_levels(r["plan"]))


def _w_uploads(r):
    # The first side's pyramid puts every blur's operators on the device
    # in one copy; the second side and the second call find them there.
    assert r["traced"]["conv.w_uploads"] == 1
    assert "conv.w_uploads" not in r["untraced"]


def _counters_without_profiler(r):
    assert r["untraced"] == {k: v for k, v in r["traced"].items()
                             if k != "conv.w_uploads"}
    assert r["traced"]["calls.batch_register_pairs"] == 1
    assert 0 < r["traced"]["orientation.kept"] <= r["traced"]["extrema.rows"]
    # On the CPU the plain version finds the extrema, not the kernels.
    assert "extrema.kernel_levels" not in r["traced"]


CHECKS = {f.__name__.lstrip("_"): f for f in (
    _upload_before_pyramid, _nothing_in_pyramid, _no_root_span,
    _sync_inside_stage, _at_most_32_nested, _sync_spans_equal_counters,
    _w_uploads, _counters_without_profiler)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_spans_and_counters(run, check):
    CHECKS[check](run)


def test_counters_reset_and_copy():
    trace.reset_counters()
    trace.count("x.y")
    trace.count("x.y", 4)
    c = trace.counters()
    c["x.y"] = 0
    assert trace.counters() == {"x.y": 5}
    trace.reset_counters()
    assert trace.counters() == {}
