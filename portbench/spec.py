"""Finds a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything else is found by name, so that a later cell, mix or
metric is a file of its own and needs no edit here:

- ``configs[i].file``: the configuration (sizes, parameters, guarantees);
- ``portbench/traffic/<traffic>.json``: the mix, which names its entry;
- ``portbench/entries/<entry>.py``: the code that drives the port;
- ``portbench/metrics/<metric>.py``: the reader of one per-layer metric;
- ``portbench/limits/<cell>.json``: the limit of each number compared.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry_file: Path
    end_to_end: list       # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    reader_files: dict     # per-layer metric name -> reader file
    limits: dict           # number compared -> limit


def load_benchmark(repo: Path = REPO) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, repo: Path = REPO) -> Cell:
    """The cell ``workload`` with its configuration, mix, entry, readers
    and limits; raises KeyError or FileNotFoundError for a missing part."""
    repo = Path(repo)
    bench = load_benchmark(repo)
    here = repo / "portbench"
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(repo / cfg["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    entry = here / "entries" / f"{traffic['entry']}.py"
    if not entry.exists():
        raise FileNotFoundError(entry)
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: here / "metrics" / f"{m['name']}.py"
               for m in per_layer}
    for p in readers.values():
        if not p.exists():
            raise FileNotFoundError(p)
    limits_file = here / "limits" / f"{workload}.json"
    limits = {}
    if limits_file.exists():
        with open(limits_file) as f:
            limits = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, entry_file=entry,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=per_layer, reader_files=readers, limits=limits)


def load_module(path: Path, name: str | None = None):
    """Import a file of the benchmark by its path (names may hold dots)."""
    path = Path(path)
    name = name or "portbench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
