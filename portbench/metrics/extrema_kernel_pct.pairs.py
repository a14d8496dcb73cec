"""Share (%) of the keypoint levels whose extrema the port's CUDA kernels
found (``csrc/extrema_scan.cu``): the ``extrema.kernel_levels`` counter
over ``extrema.levels``, over a run's calls (extrema layer). None for a
port that keeps neither counter."""

import importlib


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    kernel = counters.per_call(c, ["extrema.kernel_levels"])
    levels = counters.per_call(c, ["extrema.levels"])
    if kernel is None or not levels:
        return None
    return 100.0 * kernel / levels


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
