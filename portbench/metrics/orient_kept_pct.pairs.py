"""Share (%) of the orientation windows that kept their keypoint: the
port's ``orientation.kept`` counter over ``extrema.rows`` (the extrema
rows that orientation takes), over a run's calls (orientation layer)."""

import importlib


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    kept = counters.per_call(c, ["orientation.kept"])
    rows = counters.per_call(c, ["extrema.rows"])
    if kept is None or not rows:
        return None
    return 100.0 * kept / rows


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
