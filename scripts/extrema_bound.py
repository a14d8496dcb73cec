"""Kernel 4 (``csrc/extrema_scan.cu``) at the benchmark cell's grid, held
to its plain version and to its bounds (needs the card).

    python3 scripts/extrema_bound.py [--seed 4242424243] [--reps 5]

Makes the first pool item of ``mni152.batch64`` as ``portbench/pairs.py``
makes it from ``--seed`` (64 pairs of 182 x 218 x 182 blob volumes), and
for each side builds the pyramid and takes every keypoint level's extrema
as ``features.detect.detect`` does: rows, counts and totals against the
plain version on the same tensors, bit for bit, with the kernels' launches
read from the ``launches.extrema_scan`` counter (``chip_smoke.check_extrema``),
then the kernels' passes by CUDA events (without the host read, mean of
``--reps``), the ``extrema_levels`` call with its read, the plain version,
and ``ops/cuda_extrema.scan_work``'s counts: the function's least bytes
(each level's cur once, prev and next in the 32-byte sectors of voxels
that pass |c| > t, the rows) and the design's own, each as ms at the
H100's 3.35 TB/s. Prints the card's name and power limit, a line a side
and one JSON line with both sides and their sum (one request).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "mni152.batch64"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4242424243)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("extrema_bound: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from portbench import spec, volumes
    from sift3d_tpu_torch import SIFT3DParams, _build
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.extrema import extrema_levels
    from sift3d_tpu_torch.ops import cuda_extrema

    dev = torch.device("cuda")
    card = cs.card_line()
    _build.build_all()
    cell = spec.resolve(CELL)
    shape, t = tuple(cell.config["shape_zyx"]), cell.traffic
    per = int(t["pairs_per_request"])
    gen = volumes.generator(args.seed, dev)
    src, ref = volumes.pairs(int(t["pool"]) * per, shape, int(t["nblob"]),
                             int(t["shift_x"]), gen, dev)
    params = SIFT3DParams(**cell.config["sift3d"])
    plan = pyr.plan_pyramid(shape[::-1], tuple(cell.config["units"]), params)
    thresh = params.peak_thresh
    print(card)
    sides = {}
    for name, stack in (("src", src[:per]), ("ref", ref[:per])):
        levels = cs.extrema_sets(stack, plan, params, dev)
        check = cs.check_extrema([levels], thresh, f"{CELL} {name}")
        n = check["rows"][0]
        least, design, ops, passing, found = cuda_extrema.scan_work(levels,
                                                                    thresh)
        voxels = sum(lv[1].numel() for lv in levels)
        side = dict(
            levels=len(levels), rows=found, pass_share=passing / voxels,
            ms=cs.cuda_ms(lambda: cuda_extrema.scan(levels, thresh)[2](n),
                          args.reps),
            call_ms=cs.cuda_ms(lambda: extrema_levels(levels, thresh),
                               args.reps),
            plain_ms=cs.cuda_ms(
                lambda: cuda_extrema.scan_plain(levels, thresh), 1),
            bytes=least, design_bytes=design, ops=ops,
            level_bytes=4 * voxels)
        side["bound_ms"], side["bound_by"] = cs.bound_ms(least, ops)
        side["design_bound_ms"] = cs.bound_ms(design, ops)[0]
        sides[name] = side
        print(f"{name}: {side['levels']} levels, {found} rows, "
              f"{side['pass_share']:.4f} of the voxels pass |c| > t; "
              f"passes {side['ms']:.3f} ms, call {side['call_ms']:.3f} ms, "
              f"plain {side['plain_ms']:.1f} ms by events; least bytes "
              f"{least / 1e9:.3f} GB ({side['bound_ms']:.3f} ms), the "
              f"design's {design / 1e9:.3f} GB "
              f"({side['design_bound_ms']:.3f} ms) [{card}]")
        del levels
        torch.cuda.empty_cache()
    request = {k: sum(s[k] for s in sides.values())
               for k in ("rows", "ms", "call_ms", "plain_ms", "bytes",
                         "design_bytes", "level_bytes", "bound_ms",
                         "design_bound_ms")}
    print(json.dumps({"card": card, "cell": CELL, "seed": args.seed,
                      "sides": sides, "request": request}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
