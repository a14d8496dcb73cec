#!/usr/bin/env python3
"""Runs one cell of the port's benchmark and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. One process loads the
port, makes the cell's input pool on the card from ``--seed``, warms up
the cell's one shape, then sends requests in a closed loop with one
caller for ``--seconds``: each request is one call of the cell's entry,
timed from its start to a sync on its outputs. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` runs the same loop with
``torch.profiler`` on a fixed slice of steady requests, ends once the
slice is traced and every pool item has served a request, and reports
the per-layer metrics, read from the trace. After the window the outputs of
a sample of the requests, drawn from the seed, are compared with the
plain reference (``compare.py``), which decides ``correct``; each number
compared and its limit are the last lines on standard error and the last
key of the result line, the last line on standard output.

Exits non-zero with no result line without a CUDA card (or with fewer
than the cell asks for), and when JAX or the JAX package is loaded in
this process when the result is due.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# Kernel and compiler caches at fixed paths inside the checkout (the
# port's own kernels build into build/kernels/ there).
CACHE = os.path.join(REPO, "build", "portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FORBIDDEN = ("jax", "jaxlib", "flax", "sift3d_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             entry_cls=None, log=_log) -> dict:
    """One run of ``cell`` on ``device``; returns the result dict (the
    line's fields). ``entry_cls`` replaces the cell's entry (tests break
    the timed path with it)."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from portbench import spec, trace_read

    device = torch.device(device)
    if entry_cls is None:
        entry_cls = spec.load_module(cell.entry_file).Entry
    traffic = cell.traffic
    entry = entry_cls(cell, device)
    entry.make_pool(seed)
    pool = len(entry.pool)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    for k in range(int(traffic["warmup_requests"])):
        entry.request(k % pool)
    _sync(device)
    setup_s = time.time() - T_START

    rng = np.random.default_rng(int(seed) % 2 ** 63)
    seen = [0] * pool
    kept = {}
    lat = []
    units_done = 0
    n_trace = int(traffic["trace_requests"]) if trace else 0
    k0 = int(traffic["warmup_requests"])       # the traced slice's first
    prof = None
    trace_items = []
    t_begin = time.perf_counter()
    t_end = t_begin
    k = 0
    while True:
        if trace and k == k0:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        i = k % pool
        t0 = time.perf_counter()
        with record_function("portbench.request"):
            out = entry.request(i)
            _sync(device)
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        units_done += entry.done(out)
        if prof is not None and k < k0 + n_trace:
            trace_items.append(i)
        if prof is not None and k == k0 + n_trace - 1:
            prof.__exit__(None, None, None)
        # One output of each pool item is kept, drawn uniformly from the
        # item's requests (a reservoir of one).
        seen[i] += 1
        if rng.random() * seen[i] < 1.0:
            kept[i] = out
        del out
        k += 1
        if trace:
            # A traced run ends once its slice is traced and every pool
            # item has an output kept.
            if k >= k0 + n_trace and len(kept) == pool:
                break
        elif t_end - t_begin >= seconds:
            break
    window_s = t_end - t_begin
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    summary = {}
    if trace:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            summary = trace_read.summarize(trace_read.load_events(path))
    entry.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    result = dict(attempted=len(lat), failed=0)
    if trace:
        needs = set()
        readers = {n: spec.load_module(p) for n, p in
                   cell.reader_files.items()}
        for r in readers.values():
            needs |= set(getattr(r, "NEEDS", ()))
        summary["work"] = entry.work(trace_items, needs) if needs else {}
        units_per = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, r in readers.items():
            v = r.read(summary)
            if v is not None:
                metrics[name] = dict(value=float(v), unit=units_per[name])
        result["device_trace"] = dict(busy_s=float(summary.get("busy_s", 0)),
                                      window_s=float(summary.get("wall_s",
                                                                 0)))
        result["breakdown"] = dict(device_ops=summary.get("device_ops", []),
                                   idle_gaps=summary.get("idle_gaps", []))
    else:
        values = dict(
            setup_s=setup_s,
            request_p95_ms=float(np.percentile(lat, 95)) * 1e3,
            pairs_per_s=units_done / window_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = dict(value=float(values[m["name"]]),
                                          unit=m["unit"])
    q = np.percentile(lat, [50, 95]) * 1e3
    log(f"window {window_s:.3f} s, {len(lat)} requests, "
        f"{units_done} {entry.unit}, request ms median {q[0]:.3f} p95 "
        f"{q[1]:.3f} max {max(lat) * 1e3:.3f}, set-up {setup_s:.3f} s, "
        f"peak {peak} bytes")

    t_judge = time.perf_counter()
    numbers = entry.judge(kept, seed)["program"]
    log(f"judged in {time.perf_counter() - t_judge:.3f} s")
    checks = {}
    for name, v in numbers.items():
        limit = cell.limits.get(name)
        checks[name] = dict(value=float(v), limit=limit)
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result.update(correct=correct, metrics=metrics, peak=peak,
                  checks=checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.resolve(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        _log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
             f"this machine has {have}")
        return 2
    import sift3d_tpu_torch._build as build
    first_build = not all(build._target(n).exists() for n in build.sources())
    build.build_all()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        _log(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    card = card_name_and_limit()
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=cell.chips, memory_peak_bytes=int(res["peak"]))
    dev.update(res.get("device_trace", {}))
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"], device=dev)
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["card"] = card
    line["first_build"] = first_build
    line["checks"] = res["checks"]
    _log(f"card: {card}")
    for name, c in res["checks"].items():
        _log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
