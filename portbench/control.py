#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
        [--out FILE]

On the card, in one process: for each seed, the cell's pool is made as a
run makes it, the cell's entry serves one request on every pool item
(the timed path at the cell's own size), and the numbers that a run
compares are read twice against the plain reference: for the port (the
lower reading) and for the control, the reference computed with TF32
products in the port's place (the upper reading). Prints one JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, seeds, device, log=print) -> list:
    import torch

    from portbench import spec
    entry_cls = spec.load_module(cell.entry_file).Entry
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        entry = entry_cls(cell, device)
        entry.make_pool(seed)
        kept = {i: entry.request(i) for i in range(len(entry.pool))}
        entry.close()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        r = entry.judge(kept, seed, sides=("program", "control"))
        rec = dict(workload=cell.name, seed=seed, **r,
                   seconds=time.perf_counter() - t0)
        log(json.dumps(rec))
        out.append(rec)
        del entry, kept
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    recs = readings(cell, [int(s) for s in args.seeds.split(",")],
                    torch.device("cuda"))
    if args.out:
        with open(args.out, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
