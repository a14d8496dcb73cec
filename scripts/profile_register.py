"""Device-time breakdown of one 256^3 registration with the PyTorch port.

    python scripts/profile_register.py [--size 256] [--seed 7]

Registers ``benches.data.make_volume((size,)*3, nblob=256, seed)`` against
its copy rolled by ``SHIFT`` voxels along x with ``RegSift3D()`` on the
card: one warm-up call, then one call under ``torch.profiler``. From the
exported trace it takes the device's busy time (the union of kernel,
memcpy and memset intervals), the call's wall time and their ratio (the
device's idle share), the device time of each kernel name, and for each
stage's ``sift3d.<stage>`` span (see ``sift3d_tpu_torch/api.py``) its
host time and its device busy time. ``profile_call`` reads any call that
runs inside those spans; ``chip_smoke.py`` also profiles the batched
``parallel.pipeline.batch_register_pairs`` with it. Prints one JSON line, tagged with the
card's name and power limit. ``chip_smoke.py`` takes its stage breakdown
from ``profile_call``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benches.data import SHIFT, make_volume  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE_PREFIX = "sift3d."


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


def profile_call(fn) -> tuple[object, dict]:
    """Run ``fn()`` once under ``torch.profiler``; returns its result and
    the call's wall ms, device busy ms, idle share, the busiest kernel
    names, and for each ``sift3d.<stage>`` span its host ms and the busy
    ms of the device operations it started."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy_ms = busy_union((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3
    by_name = collections.Counter()
    n_by_name = collections.Counter()
    for e in dev:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        by_name[name[:80]] += e["dur"] / 1e3
        n_by_name[name[:80]] += 1
    top = [dict(name=k, ms=v, n=n_by_name[k])
           for k, v in by_name.most_common(12)]
    stages: dict = {}
    windows = collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        if e["name"].startswith(STAGE_PREFIX) and e.get("cat") in (
                "user_annotation", "gpu_user_annotation"):
            name = e["name"][len(STAGE_PREFIX):]
            windows[name][e["cat"]].append((e["ts"], e["ts"] + e["dur"]))
    starts = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    for name, w in windows.items():
        # A stage's device work: the device operations that start inside
        # its device-side span (its host span where the trace has none).
        spans = w.get("gpu_user_annotation") or w["user_annotation"]
        mine = [iv for iv in starts if any(s <= iv[0] < e for s, e in spans)]
        stages[name] = dict(
            host_ms=sum(e - s for s, e in w["user_annotation"]) / 1e3,
            device_busy_ms=busy_union(mine) / 1e3,
            device_span=bool(w.get("gpu_user_annotation")))
    return out, dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     idle_share=1.0 - busy_ms / wall_ms,
                     device_ops=len(dev), stages=stages, top=top)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_register: no CUDA device available", file=sys.stderr)
        return 1
    from sift3d_tpu_torch import RegSift3D

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    src = make_volume((args.size,) * 3, nblob=256, seed=args.seed)
    ref = np.roll(src, SHIFT, axis=2)
    reg = RegSift3D()
    reg.register(src, ref)                       # warm-up: kernel build, caches
    torch.cuda.synchronize()
    res, prof = profile_call(lambda: reg.register(src, ref))
    print(json.dumps(dict(card=card, size=args.size, seed=args.seed,
                          ok=bool(res.ok), **prof)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
