"""Kernel 3's offset-table build: peak device memory and time, a z-slab of
the offset box at a time against the whole box in one pass (needs the
card).

    python3 scripts/orient_table_memory.py

``ops/cuda_orient.offset_table`` forms |v|^2, the sphere mask and the
weights over the table's offset box, ``TABLE_SLAB`` candidates at a time.
For each case of ``CASES`` (table extents per axis, window radius in
voxels at unit spacing) this builds the table with the default slab and
with one slab as large as the whole box, and reports the table's bytes,
the build's peak of allocated device memory above what was allocated
before it, and its time by CUDA events. A build that runs out of device
memory is reported as such. Prints the card's name and power limit, then
one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, extent, radius): the largest table of the 256^3 raw-image call
# (extents 183), the sphere inscribed in and the whole box of a 256^3
# level's largest extents (253), and of the largest extents the kernel
# accepts (MAX_EXTENT).
CASES = (("256^3 raw, level (4, 2)", 183, 183.0),
         ("extents 253, sphere in the box", 253, 253.0),
         ("extents 253, whole box", 253, 440.0),
         ("extents 511, sphere in the box", 511, 511.0),
         ("extents 511, whole box", 511, 886.0))


def build(cuda_orient, extent, radius, slab, dev) -> dict:
    cuda_orient.TABLE_SLAB = slab
    radii, cores = (extent,) * 3, (extent + 1,) * 3
    shape = (extent + 3,) * 3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        tab = cuda_orient.offset_table(shape, radii, cores, (1.0, 1.0, 1.0),
                                       radius / 3.0, radius, dev)
        end.record()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        return dict(out_of_memory=True,
                    peak_bytes=torch.cuda.max_memory_allocated(dev) - base)
    out = dict(out_of_memory=False, entries=int(tab.shape[0]),
               table_bytes=tab.numel() * tab.element_size(),
               peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
               ms=start.elapsed_time(end))
    del tab
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("orient_table_memory: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sift3d_tpu_torch.ops import cuda_orient

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    default = cuda_orient.TABLE_SLAB
    rows = []
    for label, extent, radius in CASES:
        box = (2 * extent + 1) ** 3
        for mode, slab in (("slabs", default), ("one pass", box)):
            r = dict(case=label, extent=extent, radius=radius, box=box,
                     mode=mode, slab=slab,
                     **build(cuda_orient, extent, radius, slab, dev))
            rows.append(r)
            print(f"{label}, {mode}: " + ", ".join(
                f"{k} {v}" for k, v in r.items()
                if k not in ("case", "mode")) + f" [{card}]", flush=True)
    cuda_orient.TABLE_SLAB = default
    print(json.dumps(dict(card=card, builds=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
