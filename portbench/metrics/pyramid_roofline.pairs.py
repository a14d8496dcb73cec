"""Share (%) of the pyramid's least time on the H100 (``work/pyramid.py``'s
count of the plan's taps and of each level written once, against
``work/peaks.py``) in the device busy time of the ``sift3d.pyramid``
spans, the upload of the volumes left out."""

import importlib

NEEDS = ("pyramid",)


def read(s: dict):
    peaks = importlib.import_module("portbench.work.peaks")
    ms = s.get("span_busy_ms", {}).get("sift3d.pyramid")
    work = s.get("work", {}).get("pyramid")
    if not ms or not work:
        return None
    return 100.0 * peaks.bound_s(*work) / (ms / 1e3)
