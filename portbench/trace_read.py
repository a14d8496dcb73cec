"""Reads a ``torch.profiler`` Chrome trace of the traced slice of a run.

The arithmetic of the port's ``scripts/profile_register.py`` (device busy
time as the union of the kernel, memcpy and memset intervals), frozen
here, with the span coverage and the breakdown the per-layer metrics and
the result line need. Each device operation belongs to the host span in
which its launch ran (the CUDA runtime call with the same correlation
id), so a span's device time is the work that it queued, whenever the
device ran it. Copies from the host to the device (the uploads of the
request's volumes) are counted apart, in no span's device time: they
are bound by the host's memory and the bus, not by the stage's work.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
REQUEST = "portbench.request"
STAGE_PREFIX = "sift3d."
UPLOAD_PREFIX = "Memcpy HtoD"


def busy_union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if min(e, hi) > max(s, lo)]


def load_events(path) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def summarize(events, n_top: int = 10) -> dict:
    """Sums over the slice that the ``portbench.request`` spans cover.

    Returns the slice's wall and device-busy seconds, the requests, each
    ``sift3d.<stage>`` span's host ms and the device busy ms of the
    operations launched inside it (host-to-device copies left out), the
    device ms of the host-to-device copies, the host ms of the request spans that
    no stage span covers, the device ms of each operation name, and the
    breakdown: the device operations that took most time, and the idle
    time by the innermost host span open in the middle of each gap.
    """
    req = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e["name"] == REQUEST and e.get("cat") == "user_annotation")
    if not req:
        return {}
    lo, hi = req[0][0], max(e for _, e in req)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev_iv = _clip([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    busy = merged(dev_iv)
    busy_us = sum(e - s for s, e in busy)

    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    stages = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(STAGE_PREFIX):
            stages[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    span_host_ms = {k: sum(e - s for s, e in v) / 1e3
                    for k, v in stages.items()}
    # Each device operation goes to the innermost stage span (the latest
    # to start) open when it was launched.
    flat = sorted((s, e, k) for k, v in stages.items() for s, e in v)
    starts = [s for s, _, _ in flat]
    by_stage = collections.defaultdict(list)
    uploads = []
    for e in dev:
        if e["name"].startswith(UPLOAD_PREFIX):
            uploads.append((e["ts"], e["ts"] + e["dur"]))
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        i = bisect.bisect_right(starts, t)
        for s, end, k in reversed(flat[max(0, i - 64):i]):
            if s <= t < end:
                by_stage[k].append((e["ts"], e["ts"] + e["dur"]))
                break
    span_busy_ms = {k: busy_union(v) / 1e3 for k, v in by_stage.items()}

    stage_iv = merged(iv for v in stages.values() for iv in v)
    outside_us = 0.0
    for s, e in req:
        covered = sum(b - a for a, b in _clip(stage_iv, s, e))
        outside_us += (e - s) - covered

    op_ms = collections.Counter()
    for e in dev:
        op_ms[e["name"][:120]] += e["dur"] / 1e3

    # Idle time by what the host was doing: each gap between device
    # operations goes to the innermost host span open at its middle.
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS)
    hstarts = [s for s, _, _ in host]
    outer = [h for h in host if h[2] == REQUEST or
             h[2].startswith(STAGE_PREFIX)]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(hstarts, mid)
        name = None
        for s, e, n in reversed(host[max(0, i - 512):i]):
            if s <= mid < e:
                name = n
                break
        if name is None:
            inner = [(s, n) for s, e, n in outer if s <= mid < e]
            name = max(inner)[1] if inner else "none"
        idle[name[:120]] += b - a
    return dict(
        requests=len(req), wall_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        span_host_ms=span_host_ms, span_busy_ms=span_busy_ms,
        upload_ms=busy_union(_clip(uploads, lo, hi)) / 1e3,
        outside_ms=outside_us / 1e3, op_ms=dict(op_ms),
        device_ops=[[k, v / 1e3] for k, v in op_ms.most_common(n_top)],
        idle_gaps=[[n, d / 1e6] for n, d in idle.most_common(n_top)])
