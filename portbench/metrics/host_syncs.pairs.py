"""Device-to-host reads a request: the port's ``sync.<stage>`` counters,
summed, per call of ``batch_register_pairs`` (device layer)."""

import importlib


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    return counters.per_call(c, [k for k in c if k.startswith("sync.")])


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
