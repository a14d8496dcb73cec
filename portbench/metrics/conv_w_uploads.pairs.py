"""Blur matrices copied from the host to the card a request: the port's
``conv.w_uploads`` counter per call of ``batch_register_pairs`` (pyramid
layer)."""

import importlib


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    return counters.per_call(c, ["conv.w_uploads"])


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
