"""Every cell of BENCHMARK.json resolves to its parts, a new cell needs
only new files and entries, and the file keeps to the contract's
shapes."""

import json
import re
import shutil

import pytest

from portbench import spec

REPO = spec.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return spec.load_benchmark(REPO)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.entry_file.exists()
    assert hasattr(spec.load_module(c.entry_file), "Entry")
    for name, path in c.reader_files.items():
        assert callable(spec.load_module(path).read), name
    assert c.limits, f"{cell} has no limits file"
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert any(m["name"] != "setup_s" for m in c.end_to_end)


def test_contract_shapes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in b["paths"]:
        assert (REPO / p).is_dir() and not p.startswith("/")
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == names
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        moved = e2e[m["moves"]]
        for w in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert "workloads" not in moved or w in moved["workloads"]
    assert len(json.dumps(b)) < 64 * 1024


def test_new_cell_needs_no_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries of a copy are found by name."""
    root = tmp_path / "repo"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = json.loads((REPO / b["configs"][0]["file"]).read_text())
    cfg["shape_zyx"] = [96, 96, 96]
    (root / "portbench/configs/new96.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/batch64.json").read_text())
    mix["pool"] = 2
    (root / "portbench/traffic/newmix.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/new_metric.x.py").write_text(
        "def read(s):\n    return s.get('requests')\n")
    (root / "portbench/limits/new96.newmix.json").write_text(
        json.dumps({"match_diff": 0.5}))
    b["configs"].append(dict(name="new96", source="https://example.org",
                             file="portbench/configs/new96.json",
                             reduced=[], why="test"))
    b["workloads"].append(dict(name="new96.newmix", config="new96",
                               traffic="newmix", chips=1, why="test"))
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("new96.newmix")
    b["per_layer"].append(dict(name="new_metric.x", unit="ms",
                               better="lower", source="program_span",
                               layer="test", moves="pairs_per_s",
                               workloads=["new96.newmix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.resolve("new96.newmix", root)
    assert c.config["shape_zyx"] == [96, 96, 96]
    assert c.traffic["pool"] == 2 and c.limits == {"match_diff": 0.5}
    assert "new_metric.x" in c.reader_files
    assert spec.load_module(c.reader_files["new_metric.x"]).read(
        {"requests": 3}) == 3
    assert [m["name"] for m in c.end_to_end] == [
        m["name"] for m in b["end_to_end"]]


def test_missing_part_is_an_error(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = b["configs"][0]["name"]
    b["workloads"].append(dict(name=f"{cfg}.nomix", config=cfg,
                               traffic="nomix", chips=1, why="test"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(FileNotFoundError):
        spec.resolve(f"{cfg}.nomix", root)
