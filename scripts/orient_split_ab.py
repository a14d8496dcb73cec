"""Kernel 3's split of a row's offset list over warps, timed against fixed
splits at the shapes of ``chip_smoke.py``'s two paths (needs the card).

    python3 scripts/orient_split_ab.py [--reps 5]

``ops/cuda_orient.warps_per_row`` splits a row's list over 1-8 warps of a
block so that each warp walks at most ``ENTRIES_PER_WARP`` entries. This
script sets that constant to each of ``SETTINGS``: 512 (the default), 0
(always 8 warps a row: one row a block), 128, 2048 and 2**30 (always one
warp a row: 8 rows a block), in the order A B C D E E D C B A. For each it
times ``orient_terms_levels`` as ``features.detect.orient_levels`` calls
it, for both detections of one 256^3 registration and both sides of one
config-4 batch: the kernel alone, mean over ``--reps`` calls, from the
profiler's trace. Every setting's sums are held against the plain version
as ``chip_smoke.compare_terms`` holds them. Prints the card's name and
power limit, then one JSON line: per cell and setting, the two times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = (512, 0, 128, 2048, 1 << 30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("orient_split_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from benches.data import SHIFT, make_pairs, make_volume
    from sift3d_tpu_torch import SIFT3DParams, _build
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.detect import keypoint_levels
    from sift3d_tpu_torch.features.orientation import levels_args
    from sift3d_tpu_torch.ops import cuda_orient

    dev = torch.device("cuda")
    card = cs.card_line()
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
    cells = {
        f"{cs.SIZE}^3": (calls_of((src[None],
                                   np.roll(src, SHIFT, axis=2)[None]),
                                  plan, params), params.corner_thresh),
        "batch": (calls_of(make_pairs(cs.BATCH_PAIRS, cs.BATCH_SHAPE),
                           plan4, params4), params4.corner_thresh),
    }
    plain = {k: [cuda_orient.orient_terms_levels_plain(*c) for c in calls]
             for k, (calls, _) in cells.items()}
    times = {k: {s: [] for s in SETTINGS} for k in cells}
    worst = 0.0
    for setting in SETTINGS + SETTINGS[::-1]:
        cuda_orient.ENTRIES_PER_WARP = setting
        cuda_orient._statics.clear()        # per_block is cached per level
        for k, (calls, thresh) in cells.items():
            for c, want in zip(calls, plain[k]):
                got = cuda_orient.orient_terms_levels(*c)
                rel, _, _ = cs.compare_terms(got, want, thresh,
                                             f"{k}, setting {setting}")
                worst = max(worst, rel)
            times[k][setting].append(cs.kernel_alone_ms(
                lambda: [cuda_orient.orient_terms_levels(*c) for c in calls],
                "orient_levels_kernel", args.reps))
    print(card)
    for k, per in times.items():
        print(f"{k}: " + ", ".join(
            f"{s}: {cs.fmt_ms(t[0])} / {cs.fmt_ms(t[1])}"
            for s, t in per.items()))
    print(json.dumps({"card": card, "max_rel_err": worst,
                      "kernel_alone_ms": {k: {str(s): t for s, t in
                                              per.items()}
                                          for k, per in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
