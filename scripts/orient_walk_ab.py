"""Kernel 3's two walks timed against each other on the paths of
``chip_smoke.py`` (needs the card).

    python3 scripts/orient_walk_ab.py [--reps 5] [--out FILE]

A level's rows walk either its offset table (``ops/cuda_orient.py``
``offset_table``) or their core boxes (``box_walk``), chosen by
``BOX_WALK_ENTRIES``. This script times three settings of it: the
default, "tables" (2^27: every level of these cells has a table) and
"boxes" (0: every level walks its boxes), in the order default, tables,
boxes, boxes, tables, default, on three cells: both detections of one
256^3 registration, both sides of one config-4 batch, and the raw-image
call of one 256^3 volume (``api.assign_orientations``' one launch). Per
cell and setting it gives the kernel alone, the mean over ``--reps``
calls from the profiler's trace, and the call by CUDA events (tables
built and cached before). Then each level with rows alone, in one
profiled session per walk: its rows, table entries, box offsets and the
kernel's time by table and by box walk. Every setting's sums are held
against the first's as ``chip_smoke.compare_terms`` holds kernel and
plain. Prints the card's name and power limit, a line per cell, and one
JSON line; with ``--out`` the JSON also goes to that file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "orient_levels_kernel"


def profiled_ms(fns, reps: int) -> list[float]:
    """Mean kernel-3 time of each of ``fns`` (each launching it once),
    ``reps`` calls of each in one profiled session, from the trace's
    kernel records in launch order."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    recs = sorted((e["ts"], e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel" and
                  KERNEL in e.get("name", ""))
    assert len(recs) == reps * len(fns), (len(recs), reps * len(fns))
    return [sum(d for _, d in recs[i * reps:(i + 1) * reps]) / 1e3 / reps
            for i in range(len(fns))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("orient_walk_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from benches.data import SHIFT, make_pairs, make_volume
    from sift3d_tpu_torch import SIFT3DParams, _build, api
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.dense import smooth_scale_raw_input
    from sift3d_tpu_torch.features.detect import keypoint_levels
    from sift3d_tpu_torch.features.orientation import (levels_args,
                                                       raw_keypoint_levels)
    from sift3d_tpu_torch.ops import cuda_orient as co

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.CARD[0] = card
    _build.build_all()

    def calls_of(stacks, plan, params):
        out = []
        for vols in stacks:
            gpyr, ext = cs.extrema_of(vols, plan, params, dev)
            out.append(levels_args(keypoint_levels(gpyr, ext, plan)))
        return out

    params = SIFT3DParams()
    src = make_volume((cs.SIZE,) * 3, nblob=cs.NBLOB, seed=cs.SEED)
    plan = pyr.plan_pyramid((cs.SIZE,) * 3, (1.0, 1.0, 1.0), params)
    params4 = SIFT3DParams(**cs.BATCH_CAPS)
    plan4 = pyr.plan_pyramid(cs.BATCH_SHAPE[::-1], (1.0, 1.0, 1.0), params4)
    kp = api.Sift3D(params, device=dev).detect(src)
    smoothed = smooth_scale_raw_input(torch.as_tensor(src).to(dev),
                                      cs.RAW_UNITS, params)
    raw_levels, _ = raw_keypoint_levels(smoothed, kp, plan, cs.RAW_UNITS)
    cells = {
        f"register {cs.SIZE}^3": (calls_of(
            (src[None], np.roll(src, SHIFT, axis=2)[None]), plan, params),
            params.corner_thresh),
        "config-4 batch": (calls_of(
            make_pairs(cs.BATCH_PAIRS, cs.BATCH_SHAPE), plan4, params4),
            params4.corner_thresh),
        f"raw {cs.SIZE}^3": ([levels_args(raw_levels)],
                             params.corner_thresh),
    }
    default = co.BOX_WALK_ENTRIES
    settings = {"default": default, "tables": 1 << 27, "boxes": 0}

    def use(setting):
        co.BOX_WALK_ENTRIES = settings[setting]
        co._statics.clear()

    # Each level with rows alone, as a call of its own.
    singles = {}
    for k, (calls, _) in cells.items():
        singles[k] = []
        for rows, levels in calls:
            r0 = 0
            for lv in levels:
                n = lv[1]
                if n:
                    singles[k].append((rows[r0:r0 + n], [lv]))
                r0 += n

    out = {k: {"alone_ms": {s: [] for s in settings},
               "events_ms": {s: [] for s in settings}} for k in cells}
    sums, worst = {}, 0.0
    order = list(settings)
    try:
        for setting in order + order[::-1]:
            use(setting)
            for k, (calls, thresh) in cells.items():
                got = [co.orient_terms_levels(*c) for c in calls]
                if k in sums:
                    for g, w in zip(got, sums[k]):
                        rel, _, _ = cs.compare_terms(g, w, thresh,
                                                     f"{k}, {setting}")
                        worst = max(worst, rel)
                else:
                    sums[k] = got
                out[k]["alone_ms"][setting].append(cs.kernel_alone_ms(
                    lambda: [co.orient_terms_levels(*c) for c in calls],
                    KERNEL, args.reps))
                out[k]["events_ms"][setting].append(cs.cuda_ms(
                    lambda: [co.orient_terms_levels(*c) for c in calls],
                    args.reps))
        levels_out = {}
        for setting in ("tables", "boxes"):
            use(setting)
            for k, calls in singles.items():
                ms = profiled_ms([lambda c=c: co.orient_terms_levels(*c)
                                  for c in calls], args.reps)
                levels_out.setdefault(k, [{} for _ in calls])
                for d, c, t in zip(levels_out[k], calls, ms):
                    lv = c[1][0]
                    ext = co.table_extents(lv[3], lv[4])
                    d.update(rows=int(lv[1]), extents=list(ext),
                             box_offsets=math.prod(2 * e + 1 for e in ext))
                    if setting == "tables":
                        d["table_entries"] = int(co._level_static(
                            lv[0].shape[-3:], *lv[3:], dev)[2].shape[0])
                    d[f"{setting}_ms"] = t
    finally:
        co.BOX_WALK_ENTRIES = default
        co._statics.clear()

    print(card)
    for k, d in out.items():
        for what, per in (("kernel alone", d["alone_ms"]),
                          ("by events", d["events_ms"])):
            print(f"{k}, {what}: " + ", ".join(
                f"{s} " + " / ".join(cs.fmt_ms(t) for t in ts)
                for s, ts in per.items()))
        for lv in levels_out[k]:
            print(f"  level {lv['extents']} rows {lv['rows']} table "
                  f"{lv['table_entries']} of {lv['box_offsets']}: tables "
                  f"{lv['tables_ms']:.4f}, boxes {lv['boxes_ms']:.4f} ms")
    res = {"card": card, "max_rel_err": worst, "reps": args.reps,
           "cells": out, "levels": levels_out}
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
