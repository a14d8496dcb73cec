"""Share (%) of the volume bytes a request takes from the host whose
upload began before the other side's detection: the port's
``upload.ahead_bytes`` counter over ``upload.bytes``, over a run's calls
(api and batch entry layer)."""

import importlib


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    ahead = counters.per_call(c, ["upload.ahead_bytes"])
    total = counters.per_call(c, ["upload.bytes"])
    if ahead is None or not total:
        return None
    return 100.0 * ahead / total


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
