"""The port's process-wide counters (``sift3d_tpu_torch.utils.trace``) as
the counter readers of ``metrics/`` use them: summed over a run's calls
and divided by the calls of the cell's entry, which every call of
``batch_register_pairs`` counts as ``calls.batch_register_pairs``."""

from __future__ import annotations

import importlib

CALLS = "calls.batch_register_pairs"


def port_counters() -> dict:
    """The port's counters in this process: empty where the port keeps
    none."""
    try:
        trace = importlib.import_module("sift3d_tpu_torch.utils.trace")
    except ImportError:
        return {}
    counters = getattr(trace, "counters", None)
    return counters() if callable(counters) else {}


def per_call(c: dict, names) -> float | None:
    """The sum of the counters ``names`` a call; None without calls."""
    calls = c.get(CALLS)
    if not calls:
        return None
    return sum(c.get(n, 0) for n in names) / calls
