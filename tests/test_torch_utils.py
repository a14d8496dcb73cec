"""Port parity: checkpoint, trace and roofline utilities.

Checkpoint files written by either package are read back equal by the
other; the trace records carry the same keys and values (times aside);
every roofline cost equals the JAX package's for the same plan, and the
port's peaks are the H100 SXM data sheet's.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu import pyramid as jpyr
from sift3d_tpu.config import SIFT3DParams as JSIFT3DParams
from sift3d_tpu.features.descriptor import Descriptors as JDescriptors
from sift3d_tpu.features.keypoints import Keypoints as JKeypoints
from sift3d_tpu.register.pipeline import RegistrationResult as JResult
from sift3d_tpu.utils import checkpoint as jckpt
from sift3d_tpu.utils import roofline as jroof
from sift3d_tpu.utils import trace as jtrace

from sift3d_tpu_torch import pyramid as ppyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.convert import (descriptors_from_numpy,
                                      keypoints_from_numpy)
from sift3d_tpu_torch.register.pipeline import RegistrationResult
from sift3d_tpu_torch.utils import checkpoint as pckpt
from sift3d_tpu_torch.utils import roofline as proof
from sift3d_tpu_torch.utils import trace as ptrace

torch.set_num_threads(1)

CKPT = {"jax": jckpt, "port": pckpt}


def _desc_arrays(rng, n, cap):
    xyz = np.zeros((cap, 3))
    sd = np.zeros(cap)
    vec = np.zeros((cap, 768), np.float32)
    xyz[:n] = rng.random((n, 3)) * 60
    sd[:n] = rng.random(n) * 4 + 1
    vec[:n] = rng.random((n, 768)).astype(np.float32)
    return dict(xyz=xyz, sd=sd, vec=vec, count=n)


def _kp_arrays(rng, n, cap):
    a = dict(x=np.zeros(cap), y=np.zeros(cap), z=np.zeros(cap),
             o=np.zeros(cap, np.int32), s=np.zeros(cap, np.int32),
             sd=np.zeros(cap), R=np.zeros((cap, 3, 3), np.float32))
    for f in ("x", "y", "z", "sd"):
        a[f][:n] = rng.random(n) * 30
    a["o"][:n] = rng.integers(0, 3, n)
    a["s"][:n] = rng.integers(0, 3, n)
    a["R"][:n] = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    a["count"] = n
    return a


def _make(pkg, kind, arrays):
    if pkg == "port":
        conv = descriptors_from_numpy if kind == "desc" else \
            keypoints_from_numpy
        return conv(**arrays)
    cls = JDescriptors if kind == "desc" else JKeypoints
    return cls(**{k: jnp.asarray(v) if k != "count" else jnp.int32(v)
                  for k, v in arrays.items()})


def _load(pkg, kind, path, capacity):
    fn = getattr(CKPT[pkg], "load_descriptors" if kind == "desc" else
                 "load_keypoints")
    if pkg == "port":
        return fn(path, capacity=capacity, device="cpu")
    return fn(path, capacity=capacity)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("kind", ["desc", "kp"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
@pytest.mark.parametrize("capacity", [None, 9, 4])
def test_sets_written_by_one_read_by_other(tmp_path, kind, writer, reader,
                                           capacity):
    """7 rows saved (from a set padded to 10), loaded with the default
    capacity (7), padded to 9, or cut to 4."""
    rng = np.random.default_rng(3)
    arrays = (_desc_arrays if kind == "desc" else _kp_arrays)(rng, 7, 10)
    path = str(tmp_path / "set.npz")
    getattr(CKPT[writer], "save_descriptors" if kind == "desc" else
            "save_keypoints")(path, _make(writer, kind, arrays))
    back = _load(reader, kind, path, capacity)
    cap = capacity or 7
    n = min(7, cap)
    assert int(back.count) == n
    fields = ("xyz", "sd", "vec") if kind == "desc" else \
        ("x", "y", "z", "o", "s", "sd", "R")
    for f in fields:
        got = _np(getattr(back, f))
        assert got.shape[0] == cap, (f, got.shape)
        np.testing.assert_array_equal(got[:n], arrays[f][:n].astype(got.dtype))
        assert not got[n:].any()
    if reader == "port":
        want = {"xyz": torch.float64, "sd": torch.float64,
                "vec": torch.float32, "x": torch.float64, "o": torch.int32,
                "R": torch.float32}
        for f, dt in want.items():
            if f in fields:
                assert getattr(back, f).dtype == dt, f


def test_saves_are_atomic(tmp_path, monkeypatch):
    """A write that fails midway leaves no file under the final name (and
    only a ``.tmp_`` name beside it)."""
    arrays = _desc_arrays(np.random.default_rng(0), 3, 3)

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(pckpt.np, "savez_compressed", fail)
    with pytest.raises(OSError):
        pckpt.save_descriptors(str(tmp_path / "d"),
                               descriptors_from_numpy(**arrays))
    with pytest.raises(OSError):
        pckpt.GroupwiseCheckpoint(tmp_path / "gw").put(
            0, 1, np.zeros((2, 3)), np.zeros((2, 3)), 2)
    assert sorted(p.name for p in tmp_path.rglob("*") if p.is_file()) == \
        [".tmp_d.npz", ".tmp_edge_0_1.npz"]
    assert pckpt.GroupwiseCheckpoint(tmp_path / "gw").edges() == []


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_groupwise_edges_written_by_one_read_by_other(tmp_path, writer,
                                                      reader):
    rng = np.random.default_rng(5)
    edges = [(0, 1), (1, 2), (0, 2), (10, 3)]
    data = {e: (rng.random((n, 3)) * 50, rng.random((n, 3)) * 50, n)
            for e, n in zip(edges, (6, 9, 1, 4))}
    w = CKPT[writer].GroupwiseCheckpoint(tmp_path)
    for (i, j), (s, r, n) in data.items():
        # Padded rows past the count are not stored.
        w.put(i, j, np.concatenate([s, np.ones((3, 3))]),
              torch.as_tensor(np.concatenate([r, np.ones((3, 3))]))
              if writer == "port" else np.concatenate([r, np.ones((3, 3))]),
              n)
    (tmp_path / "edge_notes_x.npz").write_bytes(b"stray")
    (tmp_path / "edge_1_2_old.npz").write_bytes(b"stray")
    (tmp_path / ".tmp_edge_5_6.npz").write_bytes(b"partial")
    rd = CKPT[reader].GroupwiseCheckpoint(tmp_path)
    assert rd.edges() == sorted(edges, key=lambda e: f"edge_{e[0]}_{e[1]}")
    assert rd.edges() == jckpt.GroupwiseCheckpoint(tmp_path).edges()
    assert rd.has(10, 3) and not rd.has(5, 6)
    for (i, j), (s, r, n) in data.items():
        gs, gr = rd.get(i, j)
        np.testing.assert_array_equal(gs, s)
        np.testing.assert_array_equal(gr, r)
    for cap in (None, 5):
        got = rd.gather(edges, capacity=cap)
        want = jckpt.GroupwiseCheckpoint(tmp_path).gather(edges, capacity=cap)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_registration_records_written_by_one_read_by_other(tmp_path, writer,
                                                           reader):
    rng = np.random.default_rng(6)
    recs = {(0, 1): (rng.random((3, 4)), 17, True), "b7": (rng.random((3, 4)),
                                                          -1, False)}
    w = CKPT[writer].RegistrationCheckpoint(tmp_path)
    for key, (A, n, ok) in recs.items():
        w.put(key, torch.as_tensor(A) if writer == "port" else A, n, ok)
    rd = CKPT[reader].RegistrationCheckpoint(tmp_path)
    assert list(rd.keys()) == ["0_1", "b7"]
    for key, (A, n, ok) in recs.items():
        assert rd.has(key)
        gA, gn, gok = rd.get(key)
        np.testing.assert_array_equal(gA, A)
        assert (gn, gok) == (n, ok)
    assert not rd.has((2, 3))


def _records(mod, run):
    recs = []
    mod.set_log_fn(recs.append)
    try:
        run()
    finally:
        mod.set_log_fn(None)
    return recs


def _timeless(rec):
    out = {k: v for k, v in rec.items() if "seconds" not in k}
    if "stages" in rec:
        out["stages"] = sorted(rec["stages"])
    return out


def _report_inputs(pkg):
    kp = _make(pkg, "kp", _kp_arrays(np.random.default_rng(7), 5, 8))
    m = np.array([3, -1, 0, -1, 2, 7], np.int32)
    A = np.array([[1.01, 0.02, 0.0, -3.1], [0.0, 0.99, 0.01, 0.2],
                  [0.0, 0.0, 1.0, 0.4]])
    if pkg == "port":
        z = torch.zeros((6, 3), dtype=torch.float64)
        reg = RegistrationResult(A=torch.as_tensor(A),
                                 matches=torch.as_tensor(m),
                                 match_src=z, match_ref=z, num_matches=4,
                                 num_inliers=3, ok=True,
                                 inlier_mask=torch.zeros(6, dtype=torch.bool),
                                 kp_overflow=False)
        return kp, torch.as_tensor(m), reg
    z = jnp.zeros((6, 3))
    reg = JResult(A=jnp.asarray(A), matches=jnp.asarray(m), match_src=z,
                  match_ref=z, num_matches=jnp.int32(4),
                  num_inliers=jnp.int32(3), ok=jnp.bool_(True),
                  kp_overflow=jnp.bool_(False))
    return kp, jnp.asarray(m), reg


def _trace_run(mod, pkg):
    kp, m, reg = _report_inputs(pkg)
    arr = torch.ones(4) if pkg == "port" else jnp.ones(4)

    def run():
        t = mod.StageTimer("gw")
        with t.stage("match") as out:
            out["x"] = arr * 2
        with t.stage("solve") as out:
            out["res"] = reg
        with t.stage("match"):
            pass
        t.report()
        mod.stage_report(kp=kp, matches=m, registration=reg,
                         extrema_counts={(0, 1): 4, (1, 0): 2})
        mod.stage_report(kp=kp, matches=m)
    return run


def test_trace_records_match_jax():
    want = _records(jtrace, _trace_run(jtrace, "jax"))
    got = _records(ptrace, _trace_run(ptrace, "port"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert _timeless(g) == _timeless(w)
    assert [r["stage"] for r in got[:3]] == ["match", "solve", "match"]


def test_jsonl_writer_lines_match_jax(tmp_path):
    lines = {}
    for name, mod, pkg in (("jax", jtrace, "jax"), ("port", ptrace, "port")):
        path = tmp_path / f"{name}.jsonl"
        path.write_text('{"kind": "earlier"}\n')     # appends, keeps this
        mod.set_log_fn(mod.jsonl_writer(str(path)))
        try:
            _trace_run(mod, pkg)()
        finally:
            mod.set_log_fn(None)
        lines[name] = [json.loads(s) for s in path.read_text().splitlines()]
    assert len(lines["port"]) == len(lines["jax"]) == 7
    for g, w in zip(lines["port"], lines["jax"]):
        assert _timeless(g) == _timeless(w)


def test_stage_timer_syncs_only_its_results(monkeypatch):
    """The stage waits for the devices of the tensors put in ``out`` (none
    on the CPU) and for no other."""
    synced = []
    monkeypatch.setattr(ptrace.torch.cuda, "synchronize", synced.append)
    t = ptrace.StageTimer()
    with t.stage("cpu") as out:
        out["a"] = [torch.ones(2), {"b": torch.zeros(1)}]
    assert synced == [] and set(t.stages) == {"cpu"}
    devs = {torch.device("cuda", 1), torch.device("cpu")}

    class Fake:
        def __init__(self, d):
            self.device = d
    monkeypatch.setattr(ptrace, "_held_tensors", lambda x: iter(
        [Fake(d) for d in devs]))
    with t.stage("card") as out:
        out["a"] = object()
    assert synced == [torch.device("cuda", 1)]


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with ptrace.profiler_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


@pytest.mark.parametrize("dims", [(64, 64, 64), (40, 48, 32), (256, 256, 256)])
def test_roofline_costs_match_jax(dims):
    jplan = jpyr.plan_pyramid(dims, (1.0, 1.0, 1.0), JSIFT3DParams())
    pplan = ppyr.plan_pyramid(dims, (1.0, 1.0, 1.0), SIFT3DParams())

    def pair(c):
        return (c.bytes_moved, c.flops)
    assert pair(proof.pyramid_cost(pplan)) == pair(jroof.pyramid_cost(jplan))
    assert pair(proof.extrema_cost(pplan)) == pair(jroof.extrema_cost(jplan))
    assert pair(proof.descriptor_cost(300, 2744.0)) == \
        pair(jroof.descriptor_cost(300, 2744.0))
    assert pair(proof.match_cost(300, 280)) == pair(jroof.match_cost(300, 280))
    assert pair(proof.batch_register_cost(pplan, 120, 2744.0, 64)) == \
        pair(jroof.batch_register_cost(jplan, 120, 2744.0, 64))
    total = proof.StageCost(1.0, 2.0) + proof.StageCost(3.0, 4.0)
    assert pair(total.scaled(0.5)) == (2.0, 3.0)


def test_roofline_report_against_the_h100():
    costs = {"pyramid": proof.StageCost(3.35e9, 6.7e9),
             "tiny": proof.StageCost(1.0, 1.0)}
    secs = {"pyramid": 0.002, "tiny": 1e-4, "untimed": 1.0}
    want = jroof.roofline_report(secs, {k: jroof.StageCost(c.bytes_moved,
                                                           c.flops)
                                        for k, c in costs.items()})
    recs = _records(ptrace, lambda: proof.roofline_report(secs, costs))
    assert len(recs) == len(want) == 1           # short and uncosted dropped
    rec = recs[0]
    for k in ("kind", "stage", "seconds", "achieved_GBps", "achieved_TFLOPs"):
        assert rec[k] == want[0][k], k
    assert rec["chip"] == "h100-sxm"
    assert rec["hbm_pct_peak"] == 50.0           # 1675 GB/s of 3350
    assert rec["fp32_pct_peak"] == 5.0           # 3.35 TFLOP/s of 67


def test_h100_peaks_feed_chip_smoke_bounds(monkeypatch):
    peaks = proof.H100_SXM
    assert (peaks.hbm_gbps, peaks.fp32_tflops, peaks.fp64_tflops) == \
        (3350.0, 67.0, 34.0)
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    assert chip_smoke.bound_ms(3.35e12, 0.0) == (1000.0, "bytes")
    assert chip_smoke.bound_ms(0.0, 6.7e13, 3.4e13) == (2000.0, "operations")
