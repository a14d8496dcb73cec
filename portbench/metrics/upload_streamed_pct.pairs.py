"""Share (%) of the volume bytes a request takes from the host that
landed on the card after its side's pyramid work had begun (every
sub-batch of a streamed stack after the first): the port's
``upload.streamed_bytes`` counter over ``upload.bytes``, over a run's
calls (api and batch entry layer). None for a port that keeps no such
counter."""

import importlib

STREAMED = "upload.streamed_bytes"


def value(c: dict):
    counters = importlib.import_module("portbench.counters")
    if STREAMED not in c:
        return None
    streamed = counters.per_call(c, [STREAMED])
    total = counters.per_call(c, ["upload.bytes"])
    if streamed is None or not total:
        return None
    return 100.0 * streamed / total


def read(s: dict):
    counters = importlib.import_module("portbench.counters")
    return value(counters.port_counters())
