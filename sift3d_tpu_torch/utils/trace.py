"""Per-stage tracing and structured pipeline logging.

The port of ``sift3d_tpu/utils/trace.py``. The reference has no timers or
structured logs (SURVEY §5.1, §5.5); its debugging signals are implicit in
its CSV outputs (keypoint / match / inlier counts). This module makes them
first-class:

- StageTimer: wall-clock stage timing that waits for the devices of the
  stage's results, so device work is counted, not its enqueue;
- profiler_trace: a ``torch.profiler`` capture written as a Chrome trace;
- host_read: the ``sift3d.sync.<stage>`` profiler span around each of
  the pipeline's deliberate device-to-host reads, beside the
  ``sift3d.<stage>`` spans of the stages (the ``sift3d.upload`` span of
  the volume uploads is ``ops/upload``'s);
- count, counters, reset_counters: process-wide integer counters at the
  pipeline's work boundaries and of every kernel launch
  (``launches.<source>``), always on, each counting a value already on
  the host (so none adds a sync);
- stage_report: one structured dict per pipeline run (keypoint counts per
  level, match count, inlier count, residuals) - the signals a production
  registration service monitors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

_log_fn = None
_counters: dict[str, int] = {}
_counters_lock = threading.Lock()


def set_log_fn(fn) -> None:
    """Install a callable(dict) receiving every stage/report record.
    Defaults to silent; pass e.g. ``print`` or a JSON-lines writer."""
    global _log_fn
    _log_fn = fn


def _emit(record: dict) -> None:
    if _log_fn is not None:
        _log_fn(record)


def _held_tensors(x):
    """The tensors held by ``x``: a tensor, a dataclass, or a dict, list
    or tuple of them."""
    if torch.is_tensor(x):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _held_tensors(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _held_tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _held_tensors(v)


def _sync(results) -> None:
    """Wait for every CUDA device that holds one of ``results``' tensors
    (and no other)."""
    devices = {t.device for r in results for t in _held_tensors(r)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates per-stage wall times. A stage puts its results in the
    dict it is given; the stage ends once the devices that hold them are
    done, so the numbers are execution times, not dispatch times."""

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.stages: dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, stage_name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            _sync(out.values())
            dt = time.perf_counter() - t0
            self.stages[stage_name] = self.stages.get(stage_name, 0.0) + dt
            _emit({"kind": "stage", "pipeline": self.name,
                   "stage": stage_name, "seconds": round(dt, 6)})

    def report(self) -> dict:
        total = time.perf_counter() - self._t0
        rec = {"kind": "timing", "pipeline": self.name,
               "total_seconds": round(total, 6),
               "stages": {k: round(v, 6) for k, v in self.stages.items()}}
        _emit(rec)
        return rec


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; on exit it is written under ``log_dir`` as a Chrome
    trace (``<host>_<pid>.<time>.pt.trace.json``; open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (an int already on the host) to the counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter since the process started or the last
    ``reset_counters``."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


@contextlib.contextmanager
def host_read(stage: str):
    """Span ``sift3d.sync.<stage>`` around one deliberate device-to-host
    read of the stage (the host waits there for the work queued before
    it), counted as ``sync.<stage>``."""
    count(f"sync.{stage}")
    with record_function(f"sift3d.sync.{stage}"):
        yield


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stage_report(kp=None, matches=None, registration=None,
                 extrema_counts: dict | None = None) -> dict:
    """Structured per-run signals: keypoint/match/inlier counts, residuals.

    Accepts any subset of: a Keypoints set, a matches index tensor, a
    RegistrationResult. Returns (and emits) one dict.
    """
    rec: dict = {"kind": "report"}
    if extrema_counts is not None:
        rec["extrema_per_level"] = {str(k): int(v)
                                    for k, v in extrema_counts.items()}
    if kp is not None:
        rec["num_keypoints"] = int(kp.count)
    if matches is not None:
        rec["num_matches"] = int((_numpy(matches) >= 0).sum())
    if registration is not None:
        rec["num_matches"] = int(registration.num_matches) \
            if hasattr(registration, "num_matches") else rec.get("num_matches")
        rec["num_inliers"] = int(registration.num_inliers)
        rec["registration_ok"] = bool(registration.ok)
        A = _numpy(registration.A)
        rec["affine_linear_deviation"] = float(
            np.abs(A[:, :3] - np.eye(3)).max())
        rec["translation_norm"] = float(np.linalg.norm(A[:, 3]))
    _emit(rec)
    return rec


def jsonl_writer(path: str):
    """Log-record sink appending JSON lines to ``path`` (opened for each
    record, so nothing stays open between records)."""
    def write(rec: dict):
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return write
