"""A/B of the descriptor-window kernel (1) built from several sources.

    python scripts/descrip_ab.py SOURCE.cu [SOURCE.cu ...] [--rounds 2]

Builds each given ``descrip_window.cu`` (the port's own, one unpacked from
another commit with ``git archive``, or a variant) with the port's nvcc
flags into ``build/ab/``, prints each build's ptxas report, and times
kernel 1 loaded from each build in turn through
``ops/cuda_window.descrip_window`` on every level bucket of the config-4
batch (``chip_smoke.py`` phase 5's arguments: 64 pairs of 64^3 at
``bench.py``'s caps), by CUDA events (the mean of 3 calls after a warm-up
call), in the order A B ... B A, ``--rounds`` times: the builds take turns
on one card, so their times compare. Each build's histograms are held
against the first build's, and a build that sets its shared-memory
carveout reports the blocks an SM then holds. Needs the card; prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(sources) -> list[str]:
    """Compile each source into build/ab/descrip_<i>.so, all at once."""
    from sift3d_tpu_torch import _build
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        lib = os.path.join(out_dir, f"descrip_{i}.so")
        procs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (lib, proc), src in zip(procs, sources):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        print(f"{src}: " + " | ".join(
            line.split(":", 1)[1].strip() for line in log.splitlines()
            if "registers" in line))
        libs.append(lib)
    return libs


def batch_args(dev):
    """Kernel 1's arguments for every level bucket of both sides of the
    config-4 batch, as ``chip_smoke.py`` phase 5 builds them."""
    import chip_smoke as cs
    from benches.data import make_pairs
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.features import detect as detect_mod
    params = SIFT3DParams(**cs.BATCH_CAPS)
    plan = pyr.plan_pyramid(cs.BATCH_SHAPE[::-1], (1.0, 1.0, 1.0), params)
    args = []
    for vols in make_pairs(cs.BATCH_PAIRS, cs.BATCH_SHAPE):
        gpyr, ext = cs.extrema_of(vols, plan, params, dev)
        kp, vol = detect_mod.orient_levels(gpyr, ext, plan, params)
        args += [a for _, a in cs.level_args(gpyr, plan, kp, vol)]
    return args


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sources", nargs="+")
    p.add_argument("--rounds", type=int, default=2)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("descrip_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sift3d_tpu_torch import _build
    from sift3d_tpu_torch.ops.cuda_window import descrip_window

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    libs = [ctypes.CDLL(lib) for lib in build(a.sources)]
    args = batch_args(dev)

    def run():
        return [descrip_window(*x) for x in args]
    times = [[] for _ in libs]
    outs = []
    for i, lib in enumerate(libs):
        _build._libs["descrip_window"] = lib
        outs.append(torch.cat(run()))
    torch.cuda.synchronize()
    dev_max = [(o - outs[0]).abs().max().item() for o in outs]
    order = list(range(len(libs)))
    for _ in range(a.rounds):
        for i in order + order[::-1]:
            _build._libs["descrip_window"] = libs[i]
            times[i].append(cs.cuda_ms(run, 3))
    per_sm = [lib.sift3d_descrip_blocks_per_sm()
              if hasattr(lib, "sift3d_descrip_blocks_per_sm") else None
              for lib in libs]
    print(json.dumps({"card": card, "launches": len(args),
                      "rows": sum(x[3] for x in args),
                      "builds": [dict(source=s, ms=t, min_ms=min(t),
                                      max_abs_dev_from_first=d,
                                      blocks_per_sm=b)
                                 for s, t, d, b in zip(a.sources, times,
                                                       dev_max, per_sm)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
