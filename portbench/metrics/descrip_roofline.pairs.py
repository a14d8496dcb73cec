"""Share (%) of kernel 1's least time on the H100 (``work/descrip.py``'s
count on the keypoints' windows, against ``work/peaks.py``) in the
device time of its launches, found by name: the kernels of
``csrc/descrip_window.cu`` (its tile-range pass, the windows and the
slab merge)."""

import importlib

NEEDS = ("descrip",)
NAMES = ("descrip_window_kernel", "tile_range_kernel", "merge_slabs_kernel")


def read(s: dict):
    peaks = importlib.import_module("portbench.work.peaks")
    ms = sum(v for k, v in s.get("op_ms", {}).items()
             if any(n in k for n in NAMES))
    work = s.get("work", {}).get("descrip")
    if not ms or not work:
        return None
    return 100.0 * peaks.bound_s(*work) / (ms / 1e3)
