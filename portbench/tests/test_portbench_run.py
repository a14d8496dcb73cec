"""A run without a card fails, and a run whose timed path is broken
underneath comes out not correct.

The fault runs skip the harness's look for a card and drive the rest of
a run on the CPU at 40 x 48 x 44 voxels (the port's plain path), judged
by the cell's committed limits."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run, spec

REPO = spec.REPO
CELL = "mni152.batch64"


def _small(cell_name: str = CELL):
    cell = spec.resolve(cell_name)
    cell.config = dict(cell.config, shape_zyx=[40, 48, 44])
    cell.traffic = dict(cell.traffic, pool=2, sample=4, warmup_requests=1,
                        trace_requests=1, nblob=24, pairs_per_request=4)
    return cell


def _run(cell, seed=2 ** 31 + 5):
    torch.set_num_threads(4)
    return run.run_cell(cell, seed, 0.5, False, "cpu", log=lambda *a: None)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_sound_run_is_correct():
    res = _run(_small())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_answer_altered_where_produced(monkeypatch):
    """RANSAC's affine moved by one voxel along z as it is produced."""
    from sift3d_tpu_torch.register import pipeline, ransac
    orig = ransac.find_tform_ransac

    def shifted(*a, **k):
        res = orig(*a, **k)
        res.A[..., 2, 3] += 1.0
        return res
    monkeypatch.setattr(pipeline, "find_tform_ransac", shifted)
    res = _run(_small())
    assert not res["correct"], res["checks"]


def test_half_the_batch_left_out(monkeypatch):
    """The second half of the batch's pairs get no registration."""
    from sift3d_tpu_torch.parallel import pipeline
    orig = pipeline.register_pairs

    def half(d_src, d_ref, *a, **k):
        res = orig(d_src, d_ref, *a, **k)
        h = res.A.shape[0] // 2
        res.A[h:] = torch.eye(3, 4, dtype=res.A.dtype)
        res.num_matches[h:] = 0
        res.num_inliers[h:] = 0
        res.ok[h:] = False
        return res
    monkeypatch.setattr(pipeline, "register_pairs", half)
    res = _run(_small())
    assert not res["correct"], res["checks"]
    assert res["checks"]["match_diff"]["value"] > 0.2


def test_control_comes_out_not_correct(cuda):
    """The TF32 control at the cell's volume size, with one pool item of
    16 pairs (a size a test holds), on the card reads past the cell's
    limits; the port reads within them."""
    from portbench import control
    cell = spec.resolve(CELL)
    cell.traffic = dict(cell.traffic, pool=1, pairs_per_request=16)
    recs = control.readings(cell, [101, 102, 103], cuda, log=lambda *a: None)
    for r in recs:
        assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
        assert any(v > cell.limits[k] for k, v in r["control"].items()), r
    assert np.isfinite([r["seconds"] for r in recs]).all()
