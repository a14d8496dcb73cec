"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift3d_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source, into ``build/kernels/``), checks that
kernel 1's shared-memory carveout holds 4 blocks an SM, then:

1. holds the descriptor-window kernel (1) against its plain PyTorch
   version on the real pyramid levels of a 256^3 volume (max abs deviation
   <= 2e-3 on the postprocessed descriptors, rows past ``count`` zero);
2. holds the orientation-window kernel (3) against its plain version on
   every level bucket of the same volume's extrema, one level a launch
   (first 64 rows, and 5 rows past ``count`` that must come back zero),
   and as ``features.detect.orient_levels`` calls it, every row of every
   level in one launch (5 rows past each level's count): the float64
   tensor sums and the window gradient within 1e-5 of the row's largest
   |term|, and the keypoint sets that follow equal (``valid`` exact, R
   within 1e-4) except on rows whose plain eigenvalue ratio or corner
   score lies within 1e-5 of its threshold, which are counted; and holds
   the extrema kernels (4) against their plain version
   (``cuda_extrema.scan_plain``) on every keypoint level of both
   volumes' detections, one ``extrema_levels`` call a detection as
   ``features.detect.detect`` makes it: rows, counts and totals equal bit
   for bit, 3 launches (max, count, emit) and one host read a call;
3. holds the streamed-matcher kernel (2) against its plain version, at the
   main path's arguments and at multi-tile sizes with invalid and
   duplicated rows, and against the dense matcher (best and second SSD
   within fp32 rounding, indices exact; a row may differ only where the
   plain version's two SSDs agree to fp32 rounding, and such rows are
   counted);
4. drives ``RegSift3D().register(src, ref)`` on the 256^3 volume and its
   copy rolled by ``SHIFT`` voxels along x, once with the default matcher
   and once with ``MatchParams(impl="streamed")``, with the kernels' launch
   counters set to 0 just before each run and read just after (kernel 3
   exactly once per detection: 2; kernel 4 3 a detection: 6); both
   affines must meet the reference's 5e-2 / 5-voxel contract; then
   registers the first 16 config-4 pairs (64^3) one at a time and asserts
   a pass rate >= 0.60;
5. checks kernels 3 and 1 on one level bucket of the config-4 batch, with
   the rows of many volumes in one launch (1e-5 and 2e-3 as above),
   kernel 3 on every level of one side of the batch in one launch, and
   kernel 4 on every keypoint level of each side (64 volumes a call) as
   in phase 2, then drives the batched path,
   ``parallel.pipeline.batch_register_pairs``, on 64 config-4 pairs at
   ``bench.py``'s caps, counters set to 0 just before and read just after:
   kernel 3 launches once per side (one detection of all levels and
   volumes), kernel 4 3 times a side, kernel 1 once per non-empty level
   bucket of each side (not once per volume), no pair reports
   ``kp_overflow``, the pass rate is >= 0.60, and the first 16 pairs agree
   with the sequential results of phase 4 (``ok`` on >= 15, A within 1e-3
   where both are ok);
6. times each kernel, its plain version and a library yardstick (kernel 3
   as ``orient_levels`` calls it, by CUDA events and alone in the
   profiler's trace; kernel 4's passes without the host read, and the
   ``extrema_levels`` call with it, against the function's least bytes
   and the design's own, ``cuda_extrema.scan_work``), the
   batched call (min of 5, pairs/s), and profiles one 256^3 registration
   and one batched call: each stage's ``sift3d.<stage>`` span on the host
   and the device, the device's busy time and idle share
   (``scripts/profile_register.profile_call``). Kernel 1 is reported with
   its blocks per launch (``slab_plan``) and the share of box voxels that
   pass its geometry tests; kernel 2 at the
   main path's shape and at 2500 x 2300, with its tile side and target
   ranges (``match_plan``);
7. drives the user surface at 256^3: the raw-image paths (kernel 3 once,
   kernel 1 once per bucket, each against plain on the first rows), the
   resampled registration, the kp and reg CLIs on NIfTI files and the
   warp;
8. drives this slice: kernels 3 and 1 on thin levels past their old size
   limits (a table extent above 511, a core above 1024 planes) against
   plain (phase 7's raw call walks the boxes of its octave-4 and -5
   levels); config 3, ``Sift3D().dense`` at 512^3, against the
   committed C golden (``benches/golden/dense_512_seed7.npz``: the
   stride-8 subsample and the channel means within 2e-3), with its time
   and peak memory in the channel-sequential and the all-at-once form;
   the rotate variant at 128^3 (kernel 3 once per ``DENSE_ORIENT_ROWS``
   voxels, counted) against the same function with the plain
   orientation, outside counted near-threshold voxels; ``register_tps``
   on the 256^3 pair (against a numpy fit on the same inliers, and a
   deep-interior probe grid against the shift), the TPS warp,
   ``regSift3D --type tps`` and ``denseSift3D``;
9. drives groupwise registration at config-5 size: (a) 256 copies of the
   first config-4 source volume that phase 4 registers (pair 0 unless it
   failed) rolled by shifts drawn in [-4, 4] voxels an axis (volume 0
   unshifted), detected and described by ``batch_detect_describe`` in 4
   batches of 64 with the counters set to 0 just before and read just
   after (kernel 3 exactly 4 launches, kernel 1 once per non-empty level
   bucket of each batch, no ``kp_overflow``), then
   ``register.groupwise.register_groupwise`` over the 510 star + loop
   edges of ``benches.data.make_fleet``: ``ok`` and every edge ok,
   ``A[0] = I``, every ``A[i]`` within 5e-2 / 5 voxels of its shift, and
   within 1e-9 of its largest |A| of a float64 numpy solve built on the
   host from the card's matches and inlier masks; kernels 3 and 1 on the
   first batch against plain; RANSAC over the edges at several chunk
   sizes (equal bit for bit); (b) ``make_fleet(256)``'s correspondences
   through ``utils.checkpoint.GroupwiseCheckpoint``, preempted after 200
   edges and resumed, then ``groupwise_solve`` with ``num_iter=60``
   within 5e-2 / 5 of the ground truth. ``utils.trace.StageTimer`` times
   each stage (detection per batch, matching, RANSAC, solve, the whole
   call), its records go through ``set_log_fn`` and ``jsonl_writer`` to
   ``build/fleet_trace.jsonl`` and are printed with the peak device
   memory and the launch counts;
10. drives the multi-GPU paths at world size 1: a one-rank NCCL group
   through ``parallel.init_distributed`` (over a ``file://`` store under
   ``build/``) and ``make_mesh(data=1, space=1)``; (a) on the 256^3
   volume's pyramid, ``conv_sep_sharded`` within 2e-6 of ``conv_sep`` on
   every blur, ``level_extrema_sharded`` equal to ``level_extrema`` on
   every level, ``orient_level_sharded`` / ``descrip_level_sharded`` on
   the first 64 rows of each bucket against kernels 3 / 1 (``valid``
   equal outside counted near-threshold rows, R within 2e-4, descriptors
   within 2e-3), and on a batch of two (16, 12, 20) blob volumes whose
   second is scaled by 10, ``level_extrema_sharded`` equal to
   ``level_extrema`` volume by volume (each volume against its own DoG
   max; the batch's shared max is shown to drop volume 0's rows);
   (b) ``nn_match_sharded(streamed=True)`` (kernel 2
   exactly twice a call, counted) and ``nn_match_ring`` on the 256^3
   pair's sets and at 2500 x 2300, equal to ``nn_match_streamed`` and the
   dense matcher outside near-tie rows, and both with
   ``dtype=torch.float64`` (the dense branch) equal to ``nn_match(...,
   dtype=torch.float64)`` likewise; on ``decisive_sets`` (13 x 14 rows)
   all three matchers accept the decisive row in float32 and reject it
   in float64; (c) ``batch_register_pairs(mesh=)``
   on the 64 config-4 pairs, counters set to 0 just before: phase 5's
   launches, no ``kp_overflow``, A within 1e-6 of phase 5's, pass rate
   >= 0.60; then ``pipelined=True`` (levels within 2e-6 of sequential,
   pass rate >= 0.60); (d) ``register_groupwise_sharded`` on phase 9's
   descriptor sets and edges (``ok`` on every edge, A within 1e-9 of its
   largest |A| of phase 9's) and ``groupwise_solve_sharded`` on
   ``make_fleet(256)`` within 5e-2 / 5 of the truth; (e) the sharded
   batched call (min of 5, pairs/s) beside the one-device one, timed in
   turns, ``nn_match_sharded`` beside ``nn_match_streamed``,
   ``register_groupwise_sharded`` beside ``register_groupwise`` and the
   world-1 ``all_reduce`` of the 255 x 255 x 4 x 4 float64 system, with
   the card's name and power limit. The group is destroyed at the end;
11. sets the convolution's form by measurement
   (``scripts/conv_banded_ab.py``): on n^3 volumes, n in {128, 192, 256,
   384, 512}, for each axis and for the pyramid's widest and narrowest
   octave-0 taps and the dense blur's, times the dense ``conv_axis``
   against the framed form at tiles of 64, 128 and 256 in turns (min and
   median of 5 by events, TFLOP/s, peak memory), holding every framed
   result within 2e-6 of the dense one's largest |value|, and
   ``apply_banded_matrix`` likewise on the 256^3 plan's composed pyramid
   operators; asserts that ``ops/conv.py``'s ``BANDED_MIN_N`` and
   ``FRAME_TILE`` are what the rule picks from this table (``pick``).
   Then, with the form forced by the module constant: detection of the
   256^3 volume framed and dense (extrema rows equal except rows whose
   margin lies within twice the levels' DoG deviation, and orientation
   ``valid`` equal outside counted near-threshold rows, R within 2e-4),
   the pair registered framed inside the 5e-2 / 5-voxel contract; the
   256^3 ``register`` (min of 5, and its ``sift3d.pyramid`` span's device
   busy against the pyramid's arithmetic at 67 TFLOP/s) and config 3 at
   512^3 (ms by events, peak memory) as committed, dense and framed, in
   turns, with the card's name and power limit. Phase 8's golden check
   runs with the committed form and says which form its blur took;
12. runs the five examples (``examples/torch/*.py``) as a user does, each
   a ``python examples/torch/<name>.py ...`` subprocess from the repo
   root on NIfTI files under ``build/``: ``features.py`` (the keypoint
   count of an in-process ``Sift3D().detect`` of the same file),
   ``io.py`` (its output reads back equal), ``register.py`` (its printed
   A inside the 5e-2 / 5-voxel contract of the shift) and
   ``nonrigid.py`` (a warped volume of the reference's shape) on the
   256^3 pair, ``groupwise.py`` on four 128^3 volumes rolled by known
   shifts (every printed A inside the contract); each must exit 0, and
   each one's wall seconds are printed with the card's name and power
   limit.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
(after phase 10, so a fault in phases 11-12 does not withhold it) and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no ``ok``
line, when no CUDA device is present or any check fails. Per-stage and
per-bucket details go to standard error as one JSON line.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 256                 # the 256^3 registration volume
NBLOB, SEED = 256, 7       # benches.data.make_volume arguments
N_CHECK_ROWS = 64          # kernel-1 check rows per level bucket
CONFIG4_PAIRS = 16
GATE_PASS_RATE = 0.60      # bench.py's gate
DESC_TOL = 2e-3            # the descriptor contract
TIE_RTOL = 1e-6            # fp32 rounding band for matcher near-ties
# Rounding of a 768-term fp32 SSD, relative to |q|^2 + |t|^2 (n u, twice).
SSD_BAND = 2 * 768 * 2.0 ** -24
T2 = torch.tensor(0.8, dtype=torch.float32) ** 2   # the ratio test, squared
ORIENT_RTOL = 1e-5         # kernel 3 vs plain, relative to the row's max
ORIENT_R_TOL = 1e-4        # R of rows valid on both sides
NEAR_THRESH = 1e-5         # band around the 0.90 ratio and corner tests
BATCH_PAIRS = 64           # bench.py's config-4 batch
BATCH_SHAPE = (64, 64, 64)
BATCH_CAPS = dict(max_kp_per_level=192, max_kp_per_octave=(192, 64, 64, 32))
BATCH_CHECK_ROWS = 512     # kernel-1 rows of the batched bucket check
RAW_UNITS = (1.0, 1.0, 1.0)
RAW_CHECK_ROWS = (3, 4)    # rows of each bucket checked: kernels 3 and 1
RAW_DESC_BOUND = 0.2       # rawDescriptorTest (Sift3DTest.m:179-201)
RAW_ANGLE_BOUND = np.pi / 8  # rawOrientationTest (Sift3DTest.m:205-242)
CSV_FIELD = re.compile(r"-?\d+\.\d{6}")
# Phase 8. F1: thin levels past kernel 3's old 511-voxel table extent and
# kernel 1's old 1024-plane core, with the sd that takes each there.
F1_K3 = ((600, 8, 8), 140.0)
F1_K1 = ((1100, 8, 8), 40.0)
DENSE_SIZE = 512           # config 3 (benches/make_dense_golden.py)
DENSE_STRIDE = 8
DENSE_GOLDEN = "benches/golden/dense_512_seed7.npz"
ROT_SIZE = 128             # the dense rotate variant
# Every voxel is a row there, and in the blank background between blobs
# a row's gradients are denormal fp32: its float32 window gradient differs
# from plain by its rounding in another order, relative to terms near
# 1e-80. Such rows are held to ORIENT_RTOL of this floor instead (|vd|^2 >=
# 1e-10 rejects them on both sides, and their outcome is still compared).
ROT_TERM_FLOOR = 1e-20
TPS_PROBE = np.arange(96, 161, 16)   # deep-interior probe grid (voxels)
# The card's spline is held to a float64 numpy fit on the host from the
# same inlier coordinates (params, mm) and must map its control points onto
# their matched source points (mm; reg moves them by reg |w|, 3.8e-8 mm at
# 48^3 on the CPU). The probe's bound at 48^3 is 1.5 voxels
# (tests/test_tps_shard_match.py); the spline passes through the inliers,
# which RANSAC keeps up to err_thresh (5 mm) from the affine, so the probe
# is held to the larger of that and the inliers' own largest distance from
# the shift (match data, not the spline's output).
TPS_REG = 1e-6             # register_tps's default bending-energy term
TPS_PARAM_TOL = 1e-6
TPS_CTRL_TOL = 1e-5
TPS_PROBE_TOL = 1.5
# Phase 9: the config-5 fleet (BASELINE.md config 5: 256 volumes, 510 star
# + loop edges) as rolled copies of one config-4 source volume.
FLEET_VOLUMES = 256
FLEET_CHUNK = 64           # volumes a batch_detect_describe call
FLEET_SHIFT = 4            # shifts drawn in [-4, 4] voxels an axis
FLEET_SEED = 5
FLEET_LIN_TOL, FLEET_T_TOL = 5e-2, 5.0   # the reference's contract
FLEET_SOLVE_RTOL = 1e-9    # card vs numpy solve, of the largest |A|
FLEET_KILL_AFTER = 200     # simulated preemption (bench_groupwise.py:85)
FLEET_SWEEP = (16, 64, 128, 256, 510)    # RANSAC chunks, edges
# Phase 10: the sharded paths at world size 1 against the one-device ones
# (tests/test_torch_parallel.py's bounds for conv and R).
CONV_TOL = 2e-6
SHARD_R_TOL = 2e-4
# F3's batch: B = 2 blob volumes of (16, 12, 20) as prev / cur / nxt DoG
# levels (seeds 1, 3, 5 + 10 b), volume 1 scaled by 10.
F3_SHAPE = (16, 12, 20)
F3_SCALE = 10.0
F3_THRESH, F3_CAP = 0.1, 64
# F2's decisive sets (``decisive_sets``): DECISIVE_GOOD rows that match
# their twins, then one query whose best and second SSDs are integers,
# with |q|^2 DECISIVE_Q2 and second SSD DECISIVE_B.
DECISIVE_GOOD = 12
DECISIVE_SHIFT = np.array([2.0, -1.0, 3.0])   # src = ref + shift (x, y, z)
DECISIVE_Q2 = 4_000_000
DECISIVE_B = 1_000_000
# Phase 12: the examples (examples/torch/*.py) run as a user runs them;
# groupwise.py on rolled copies of one 128^3 volume (z, y, x rolls).
EXAMPLE_GW_SIZE = 128
EXAMPLE_GW_NBLOB = 256
EXAMPLE_GW_ROLLS = ((0, 0, 0), (2, -3, 1), (-1, 2, 3), (3, 1, -2))
EXAMPLE_TIMEOUT = 300      # seconds an example may take
CARD = [""]                # the card's name and power limit, once read
# Kernels 1, 2 and 3 by source, the order of the launch counts printed.
KERNELS_1_2_3 = ("descrip_window", "match_stream", "orient_window")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, ops64: float = 0.0
             ) -> tuple[float, str]:
    """The least time of the work on the card: bytes over its memory rate
    or fp32 and fp64 operations over their peaks (``utils/roofline.py``'s
    H100 SXM data-sheet rates), whichever is larger."""
    from sift3d_tpu_torch.utils.roofline import H100_SXM as peaks
    t_bytes = nbytes / (peaks.hbm_gbps * 1e9) * 1e3
    t_ops = (ops / (peaks.fp32_tflops * 1e12) +
             ops64 / (peaks.fp64_tflops * 1e12)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_args(gpyr, plan, kp, vol=None, limit=None, step=1):
    """Kernel-1 arguments of every non-empty level bucket of ``kp`` (rows
    of a batch when ``vol`` gives each row's volume)."""
    from sift3d_tpu_torch.features.descriptor import (level_buckets,
                                                      level_geometry)
    out = []
    for (o, s), rows in level_buckets(kp, plan):
        rows = rows[::step][:limit]
        level = gpyr[(o, s)]
        units = plan.octave_units(o)
        sigma, rad, radii, cores = level_geometry(
            plan.gpyr_level(o, s).scale, units, level.shape[-3:])
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        out.append(((o, s), (level, centers, kp.R[rows], len(rows), radii,
                             cores, units, sigma, rad,
                             None if vol is None else vol[rows])))
    return out


def extrema_of(vols, plan, params, dev):
    """The pyramid and the batched extrema rows of a (B, nz, ny, nx)
    stack, as ``features.detect.detect`` computes them."""
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.detect import detect_extrema_levels
    v = torch.as_tensor(np.asarray(vols)).to(device=dev, dtype=torch.float32)
    gpyr = pyr.build_gpyr(pyr.im_scale(v), plan)
    return gpyr, detect_extrema_levels(pyr.build_dog(gpyr, plan), plan,
                                       params)


def extrema_sets(vols, plan, params, dev):
    """``features.extrema.extrema_levels``' levels of a (B, nz, ny, nx)
    stack's detection, as ``features.detect.detect`` builds them."""
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.detect import extrema_args
    v = vols if torch.is_tensor(vols) else torch.as_tensor(np.asarray(vols))
    v = v.to(device=dev, dtype=torch.float32)
    gpyr = pyr.build_gpyr(pyr.im_scale(v), plan)
    return extrema_args(pyr.build_dog(gpyr, plan), plan, params)


def check_extrema(sets, peak_thresh, label) -> dict:
    """Kernel 4 (``features.extrema.extrema_levels`` on card tensors)
    against its plain version on the same tensors, one detection's levels
    a call: rows, counts and totals equal bit for bit, 3 launches a group
    of ``MAX_LEVELS`` levels (2 where no row is emitted) and one host read
    a call. Returns the rows of each call besides the totals."""
    from sift3d_tpu_torch.features import extrema
    from sift3d_tpu_torch.ops import cuda_extrema
    from sift3d_tpu_torch.utils import trace
    rows, totals, n_launches = [], 0, 0
    for levels in sets:
        before = launches("extrema_scan")
        reads = trace.counters().get("sync.extrema", 0)
        got = extrema.extrema_levels(levels, peak_thresh)
        torch.cuda.synchronize()
        n_launch = launches("extrema_scan") - before
        count, total, emit = cuda_extrema.scan_plain(levels, peak_thresh)
        n = int(count.sum())
        want = torch.split(emit(n), count.sum(1).tolist())
        groups = -(-len(levels) // cuda_extrema.MAX_LEVELS)
        assert n_launch == groups * (3 if n else 2), (label, n_launch)
        assert trace.counters()["sync.extrema"] == reads + 1, label
        for l, ((r, c, t), w) in enumerate(zip(got, want)):
            assert torch.equal(c, count[l]) and torch.equal(t, total[l]), \
                f"{label}: level {l}: counts {c} / {count[l]}, totals {t} / " \
                f"{total[l]}"
            assert torch.equal(r, w), f"{label}: level {l}: rows differ"
        rows.append(n)
        totals += int(total.sum())
        n_launches += n_launch
    n_vols = sets[0][0][1].shape[0]
    print(f"extrema_scan {label} vs plain: {len(sets)} calls of "
          f"{len(sets[0])} levels, {n_vols} volumes a call, {sum(rows)} rows "
          f"({totals} before the caps), {n_launches} launches: rows, counts "
          f"and totals equal bit for bit")
    return dict(calls=len(sets), levels=sum(len(lv) for lv in sets),
                volumes=n_vols, rows=rows, totals=totals, launches=n_launches)


def orient_args(gpyr, ext, plan, limit=None):
    """Kernel-3 arguments of every level with extrema rows (the rows of
    all the volumes of the stack)."""
    from sift3d_tpu_torch.features.detect import kp_levels
    from sift3d_tpu_torch.features.orientation import level_geometry
    out = []
    for o, s in kp_levels(plan):
        rows = ext[(o, s)][0][:limit]
        if not rows.shape[0]:
            continue
        level = gpyr[(o, s)]
        units = plan.octave_units(o)
        sigma, rad, radii, cores = level_geometry(
            plan.gpyr_level(o, s).scale, units, level.shape[-3:])
        out.append(((o, s), (level, rows[:, 1:], rows.shape[0], radii, cores,
                             units, sigma, rad, rows[:, 0])))
    return out


def near_threshold(A6, vd, corner_thresh):
    """Rows whose eigenvalue ratio or corner score (from these sums) lies
    within NEAR_THRESH of its threshold."""
    from sift3d_tpu_torch.features.orientation import orientation_scores
    _, _, ratio, corner = orientation_scores(A6, vd)
    return ((ratio - 0.90).abs() <= NEAR_THRESH).any(-1) | \
        ((corner - corner_thresh).abs() <= NEAR_THRESH)


def compare_terms(got, want, corner_thresh, where,
                  floor: float = 1e-300) -> tuple[float, float, int]:
    """Kernel 3's sums ``got`` against the plain version's ``want`` (rows
    below count): within ORIENT_RTOL of each row's largest |term| (or of
    ``floor`` where that is smaller), and the keypoint sets that follow
    equal except on near-threshold rows. Returns (max relative deviation,
    max abs deviation, rows that differ)."""
    from sift3d_tpu_torch.features.orientation import orientations_from_tensor
    (A_k, vd_k), (A_p, vd_p) = got, want
    assert A_k.dtype == torch.float64, "kernel 3 sums must be float64"
    if not A_p.shape[0]:
        return 0.0, 0.0, 0
    scale = torch.maximum(A_p.abs().amax(1), vd_p.abs().amax(1).double())
    dev_ = torch.maximum((A_k - A_p).abs().amax(1),
                         (vd_k - vd_p).abs().amax(1).double())
    rel = (dev_ / scale.clamp(min=floor)).max().item()
    assert rel <= ORIENT_RTOL, f"{where}: kernel 3 rel dev {rel:.3e}"
    R_k, ok_k = orientations_from_tensor(A_k, vd_k, corner_thresh)
    R_p, ok_p = orientations_from_tensor(A_p, vd_p, corner_thresh)
    near_rows = near_threshold(A_p, vd_p, corner_thresh)
    r_dev = (R_k - R_p).abs().amax((1, 2))
    diff = (ok_k != ok_p) | (ok_k & ok_p & (r_dev > ORIENT_R_TOL))
    bad = diff & ~near_rows
    assert not bad.any(), \
        f"{where}: {int(bad.sum())} keypoint rows differ from plain"
    return rel, dev_.max().item(), int(diff.sum())


def check_orient(buckets, corner_thresh, label) -> dict:
    """Kernel 3 (one level a launch) against its plain version on each
    bucket (5 extra rows past count must be zero), then the keypoint sets
    that follow."""
    from sift3d_tpu_torch.ops.cuda_orient import (orient_terms,
                                                  orient_terms_plain)
    worst_rel = worst_abs = 0.0
    near = rows = 0
    for lv, a in buckets:
        level, zyx, n, geom, vol = a[0], a[1], a[2], a[3:8], a[8]
        pad = 5
        zyx_p = torch.cat([zyx, zyx[:1].expand(pad, 3)])
        vol_p = torch.cat([vol, vol[:1].expand(pad)])
        A_k, vd_k = orient_terms(level, zyx_p, n, *geom, vol_p)
        want = orient_terms_plain(level, zyx, n, *geom, vol)
        torch.cuda.synchronize()
        assert torch.all(A_k[n:] == 0) and torch.all(vd_k[n:] == 0), \
            f"{label} {lv}: rows past count not zero"
        rel, err, diff = compare_terms((A_k[:n], vd_k[:n]), want,
                                       corner_thresh, f"{label} {lv}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        near += diff
        rows += n
    print(f"orient_window vs plain ({label}): {rows} rows over "
          f"{len(buckets)} level buckets, max rel dev {worst_rel:.3e} "
          f"(tolerance {ORIENT_RTOL}), max abs dev {worst_abs:.3e}; "
          f"keypoint sets equal except {near} near-threshold rows")
    return dict(rows=rows, buckets=len(buckets), max_rel_err=worst_rel,
                max_abs_err=worst_abs, near_threshold_rows=near)


def padded(rows, args, pad):
    """``orient_terms_levels`` arguments with ``pad`` rows past each
    level's count (copies of its first row), which must come back zero."""
    out_rows, out_args, r0 = [], [], 0
    for a in args:
        n = a[1]
        r = rows[r0:r0 + n]
        if n:
            r = torch.cat([r, r[:1].expand(pad, 4)])
        out_rows.append(r)
        out_args.append((a[0], r.shape[0], n, *a[3:]))
        r0 += n
    return torch.cat(out_rows), out_args


def check_orient_levels(calls, corner_thresh, label) -> dict:
    """Kernel 3 as ``orient_levels`` calls it, every level of a detection
    in one launch (5 rows past each level's count), against the plain
    version on the same rows, then the keypoint sets that follow."""
    from sift3d_tpu_torch.ops.cuda_orient import (orient_terms_levels,
                                                  orient_terms_levels_plain)
    worst_rel = worst_abs = 0.0
    near = rows = levels = 0
    for c, (r_all, args) in enumerate(calls):
        rows_p, args_p = padded(r_all, args, 5)
        before = launches("orient_window")
        A_k, vd_k = orient_terms_levels(rows_p, args_p)
        assert launches("orient_window") == before + 1
        A_p, vd_p = orient_terms_levels_plain(r_all, args)
        torch.cuda.synchronize()
        r0 = 0
        keep = []
        for a in args_p:
            n, count = a[1], a[2]
            assert torch.all(A_k[r0 + count:r0 + n] == 0) and \
                torch.all(vd_k[r0 + count:r0 + n] == 0), \
                f"{label} call {c}: rows past count not zero"
            keep.append(torch.arange(r0, r0 + count, device=A_k.device))
            r0 += n
            levels += int(count > 0)
        keep = torch.cat(keep)
        rel, err, diff = compare_terms((A_k[keep], vd_k[keep]), (A_p, vd_p),
                                       corner_thresh, f"{label} call {c}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        near += diff
        rows += A_p.shape[0]
    print(f"orient_window, one launch a detection, vs plain ({label}): "
          f"{rows} rows of {levels} levels in {len(calls)} launches, max rel "
          f"dev {worst_rel:.3e} (tolerance {ORIENT_RTOL}), max abs dev "
          f"{worst_abs:.3e}; keypoint sets equal except {near} near-threshold "
          f"rows")
    return dict(rows=rows, levels=levels, launches=len(calls),
                max_rel_err=worst_rel, max_abs_err=worst_abs,
                near_threshold_rows=near)


def check_descrip_window(buckets, label) -> float:
    from sift3d_tpu_torch.features.descriptor import postprocess
    from sift3d_tpu_torch.ops.cuda_window import (descrip_window,
                                                  descrip_window_plain)
    worst = 0.0
    assert buckets, f"no keypoints ({label})"
    for lv, args in buckets:
        level, centers, R, n = args[:4]
        geom, vol = args[4:9], args[9]
        pad = 5   # rows past count: the kernel must write zeros there
        centers_p = torch.cat([centers, centers[:1].expand(pad, 3)])
        R_p = torch.cat([R, R[:1].expand(pad, 3, 3)])
        vol_p = None if vol is None else torch.cat([vol, vol[:1].expand(pad)])
        got = descrip_window(level, centers_p, R_p, n, *geom, vol_p)
        want = descrip_window_plain(level, centers, R, n, *geom, vol)
        torch.cuda.synchronize()
        assert torch.all(got[n:] == 0), f"rows past count not zero at {lv}"
        dev = (postprocess(got[:n]) - postprocess(want)).abs().max().item()
        log(f"kernel 1 ({label}) level {lv}: {n} rows, cores {args[5]}, "
            f"max |dev| {dev:.3e}")
        worst = max(worst, dev)
    print(f"descrip_window vs plain ({label}): max abs deviation "
          f"{worst:.3e} over {len(buckets)} level buckets "
          f"(tolerance {DESC_TOL})")
    assert worst <= DESC_TOL, worst
    return worst


def _fragile(best, second, t2):
    """Rows whose top-2 or ratio decision sits within fp32 rounding."""
    scale = torch.clamp(best.abs(), min=1e-30)
    near_tie = (second - best).abs() <= TIE_RTOL * scale
    near_ratio = (best - t2 * second).abs() <= TIE_RTOL * scale
    return near_tie | near_ratio


def check_reduce(q, t, qs, ts, name) -> tuple[int, float]:
    """Kernel 2 against its plain version on one direction's arguments.

    Best and second must agree to fp32 rounding of the SSD; the index must
    be exact except on rows that the plain version's own (best, second)
    marks as near-ties. Returns (rows whose index differs, max |best dev|).
    """
    from sift3d_tpu_torch.ops.cuda_match import (reduce_one_way,
                                                 reduce_one_way_plain)
    kb, ks, ki = reduce_one_way(q, t, qs, ts)
    pb, ps, pi = reduce_one_way_plain(q, t, qs, ts)
    torch.cuda.synchronize()
    fin_t = ts[torch.isfinite(ts)]
    band = SSD_BAND * (qs + (fin_t.max() if fin_t.numel() else 0.0))
    for k, p, what in ((kb, pb, "best"), (ks, ps, "second")):
        fin = torch.isfinite(p)
        assert torch.equal(fin, torch.isfinite(k)), f"{name}: {what} finite"
        off = fin & ((k - p).abs() > band)
        assert not off.any(), \
            f"{name}: {int(off.sum())} {what} SSDs differ past fp32 rounding"
    diff = ki != pi
    bad = diff & ~_fragile(pb, ps, T2)
    assert not bad.any(), f"{name}: {int(bad.sum())} rows differ from plain"
    fin = torch.isfinite(pb)
    err = (kb - pb)[fin].abs().max().item() if fin.any() else 0.0
    return int(diff.sum()), err


def main_path_args(d1, d2):
    """Both directions' kernel-2 arguments as ``nn_match_streamed`` builds
    them from the main path's descriptor sets."""
    inf = float("inf")
    s1 = torch.where(d1.valid_mask(), (d1.vec * d1.vec).sum(1), inf)
    s2 = torch.where(d2.valid_mask(), (d2.vec * d2.vec).sum(1), inf)
    return [(d1.vec, d2.vec, s1, s2), (d2.vec, d1.vec, s2, s1)]


def check_match_kernel(d_src, d_ref, dev) -> dict:
    from sift3d_tpu_torch.features.match import nn_match
    from sift3d_tpu_torch.ops.cuda_match import nn_match_streamed
    n_fragile = 0
    max_err = 0.0
    for name, args in zip(("main forward", "main backward"),
                          main_path_args(d_src, d_ref)):
        n, err = check_reduce(*args, name)
        n_fragile += n
        max_err = max(max_err, err)
    main_shape = (d_src.capacity, d_ref.capacity)

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def unit_rows(n):
        r = torch.rand((n, 768), generator=g)
        return (r / r.norm(dim=1, keepdim=True)).to(dev)

    n1, n2 = 2500, 2300
    d1 = torch.cat([d_src.vec[:d_src.count], unit_rows(n1 - d_src.count)])
    d2 = torch.cat([d_ref.vec[:d_ref.count], unit_rows(n2 - d_ref.count)])
    d2[2000:2010] = d2[:10]            # duplicated targets: exact ties
    d1[2400:2405] = d1[:5]             # duplicated queries
    v1 = torch.ones(n1, dtype=torch.bool, device=dev)
    v2 = torch.ones(n2, dtype=torch.bool, device=dev)
    v1[[3, 1700, 2499]] = False
    v2[[5, 2299]] = False
    inf = float("inf")
    q1 = torch.where(v1, (d1 * d1).sum(1), inf)
    q2 = torch.where(v2, (d2 * d2).sum(1), inf)
    for name, args in (("forward", (d1, d2, q1, q2)),
                       ("backward", (d2, d1, q2, q1))):
        n, err = check_reduce(*args, name)
        n_fragile += n
        max_err = max(max_err, err)
    m_stream = nn_match_streamed(d1, d2, 0.8, v1, v2)
    m_dense = nn_match(d1, d2, 0.8, v1, v2)
    n_fragile += same_matches(d1, d2, v1, v2, m_stream, m_dense,
                              "streamed vs dense")
    n_matched = int((m_dense >= 0).sum())
    print(f"match_stream vs plain at the main path's {main_shape[0]}x"
          f"{main_shape[1]} and vs plain and dense at {n1}x{n2}: indices "
          f"exact, {n_fragile} near-tie rows differ, {n_matched} matches, "
          f"max |best SSD dev| {max_err:.3e}")
    return dict(main_shape=main_shape, n1=n1, n2=n2,
                near_tie_rows=n_fragile, matches=n_matched,
                max_abs_err=max_err)


def same_matches(d1, d2, v1, v2, got, want, label) -> int:
    """``got`` may differ from ``want`` only on rows whose top-2 or ratio
    decision sits within fp32 rounding by the dense SSD: forward, or
    backward at the dense best target or at ``got``'s; returns the rows
    that differ."""
    from sift3d_tpu_torch.features.match import ssd_matrix
    diff = got != want
    if not diff.any():
        return 0
    inf = float("inf")
    D = ssd_matrix(d1, d2)
    D = torch.where(v1[:, None] & v2[None, :], D, inf)
    fv = torch.topk(D, 2, dim=1, largest=False).values
    bv = torch.topk(D.T, 2, dim=1, largest=False).values
    fr = _fragile(fv[:, 0], fv[:, 1], T2)
    br = _fragile(bv[:, 0], bv[:, 1], T2)
    j = torch.argmin(D, dim=1)
    ok = fr | br[j] | br[got.clamp(min=0).long()]
    assert not (diff & ~ok).any(), \
        f"{label}: {int((diff & ~ok).sum())} rows differ"
    return int(diff.sum())


def count_buckets(kp, ext) -> tuple[int, int]:
    """The launches kernels 3 and 1 should make for one side of a batch:
    one for the detection if any level has extrema rows, and one per
    level bucket of kept keypoints."""
    n_orient = int(any(rows.shape[0] > 0 for rows, _, _ in ext.values()))
    valid = kp.valid_mask()
    n_desc = len({(int(o), int(s)) for o, s in
                  zip(kp.o[valid].tolist(), kp.s[valid].tolist())})
    return n_orient, n_desc


def _trace_us(fn, names, reps: int) -> list[float]:
    """Durations (us) of the kernels whose name holds one of ``names`` in
    the profiler's trace of ``reps`` calls of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e["dur"] for e in events if e.get("ph") == "X" and
            e.get("cat") == "kernel" and
            any(n in e.get("name", "") for n in names)]


def kernel_alone_ms(fn, name, reps: int, tries: int = 4) -> float | None:
    """Device time of the kernels whose name holds ``name`` (or one of a
    tuple of names), per call of ``fn``, from the profiler's trace of
    ``reps`` calls; None when no trace held a record of them. A trace can
    lack kernel records (on the H100 readings came out at 2/3 and 1/10 of
    the same call's time by events, as if one record of 3 and 9 of 10
    were missing, and one trace of a fleet batch held none of its 5), and
    a lost record only lowers the count: traces are taken until two hold
    the same number of records, at most ``tries``, and the fullest is
    used. The callers' times by events do not depend on the profiler."""
    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    traces = [_trace_us(fn, names, reps)]
    while len(traces) < tries:
        traces.append(_trace_us(fn, names, reps))
        if any(len(t) == len(traces[-1]) > 0 for t in traces[:-1]):
            break
    us = max(traces, key=len)
    if not us:
        log(f"no {names} kernel record in {len(traces)} profiler traces: "
            f"the time alone is not measured")
        return None
    return sum(us) / 1e3 / reps


def fmt_ms(t: float | None, prec: int = 4) -> str:
    """``t`` in ms at ``prec`` decimals, or "not measured" for None."""
    return "not measured" if t is None else f"{t:.{prec}f} ms"


def work_sum(fn, args) -> list[float]:
    """Elementwise sum of ``fn(*a)`` over the argument lists."""
    tot = None
    for a in args:
        w = fn(*a)
        tot = list(w) if tot is None else [x + y for x, y in zip(tot, w)]
    return tot


def raw_k1_args(smoothed, plan, kp, params, limit=None):
    """Kernel-1 arguments of every non-empty level bucket of the raw-image
    path (``features.descriptor.raw_desc_args``, what ``extract_raw``
    launches), cut to the first ``limit`` rows of each."""
    from sift3d_tpu_torch.features.descriptor import raw_desc_args
    out = []
    for lv, _, args in raw_desc_args(smoothed, kp, plan, params, RAW_UNITS):
        level, centers, R, _, *rest = args
        out.append((lv, (level, centers[:limit], R[:limit],
                         len(centers[:limit]), *rest)))
    return out


def first_rows(call, limit):
    """The indices of the first ``limit`` rows of each level of an
    ``orient_terms_levels`` call, and that call cut to those rows."""
    rows, args = call
    keep, cut, r0 = [], [], 0
    for a in args:
        n = a[1]
        m = min(n, limit)
        keep.append(torch.arange(r0, r0 + m, device=rows.device))
        cut.append((a[0], m, min(a[2], m), *a[3:]))
        r0 += n
    keep = torch.cat(keep)
    return keep, (rows[keep], cut)


def check_csv(path, cols) -> int:
    """The reference's CSV format (write_Mat_rm): no header, every row
    ``cols`` comma-separated ``%f`` fields. Returns the row count."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    assert lines, f"{path}: empty"
    for line in lines:
        fields = line.split(",")
        assert len(fields) == cols, f"{path}: {len(fields)} columns"
        assert all(CSV_FIELD.fullmatch(v) for v in fields), \
            f"{path}: a field is not %f: {line[:80]}"
    return len(lines)


def run_cli(module, argv, dev) -> tuple[int, dict]:
    """``module.main(argv)`` with its file reads and writes timed; returns
    (exit code, wall / read / write / compute seconds). Everything between
    the reads and the writes (including the device syncs that copy results
    to the host) is compute."""
    spent = {"read": 0.0, "write": 0.0}
    saved = {}

    def timed(fn, kind):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[kind] += time.perf_counter() - t0
        return wrapper
    for name in dir(module):
        kind = ("read" if name == "im_read" else
                "write" if name == "im_write" or name.startswith("write_")
                else None)
        if kind:
            saved[name] = getattr(module, name)
            setattr(module, name, timed(saved[name], kind))
    try:
        t0 = time.perf_counter()
        rc = module.main(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    spent.update(wall=wall, compute=wall - spent["read"] - spent["write"])
    return rc, spent


def launches(source: str) -> int:
    """The launches of the kernel of ``csrc/<source>.cu`` so far: the
    port's counter ``launches.<source>``."""
    from sift3d_tpu_torch.utils import trace
    return trace.counters().get(f"launches.{source}", 0)


def angle_median(R1, R2) -> float:
    tr = torch.einsum("kij,kij->k", R1.double(), R2.double())
    return float(torch.median(torch.arccos(((tr - 1) / 2).clamp(-1, 1))))


def event_ms(fn):
    """(fn(), its device time in ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rotations(n, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.array([np.linalg.qr(a)[0] for a in
                                     rng.standard_normal((n, 3, 3))],
                                    np.float32)).to(dev)


def check_f1(dev, corner_thresh) -> dict:
    """Kernels 3 and 1 on thin levels past their old limits (ROADMAP F1):
    a table extent above 511 (kernel 3 walks the rows' boxes) and a core
    above 1024 planes, each against its plain version with its launch
    counted, and timed."""
    from benches.data import make_volume
    from sift3d_tpu_torch.features import descriptor as fdesc
    from sift3d_tpu_torch.features.orientation import level_geometry
    from sift3d_tpu_torch.ops import cuda_orient, cuda_window

    shape, sd = F1_K3
    level = torch.as_tensor(make_volume(shape, nblob=40, seed=SEED)).to(dev)
    sigma, rad, radii, cores = level_geometry(sd, RAW_UNITS, shape)
    ext = cuda_orient.table_extents(radii, cores)
    assert max(ext) > cuda_orient.MAX_EXTENT and \
        cuda_orient.box_walk(radii, cores), ext
    zyx = torch.tensor([[1, 1, 1], [300, 4, 4], [598, 6, 6], [150, 2, 5],
                        [450, 5, 3], [37, 6, 1]], device=dev)
    rows = torch.cat([torch.zeros_like(zyx[:, :1]), zyx], 1)
    args = [(level, len(zyx), len(zyx), radii, cores, RAW_UNITS, sigma, rad)]
    before = launches("orient_window")
    got = cuda_orient.orient_terms_levels(rows, args)
    torch.cuda.synchronize()
    launches3 = launches("orient_window") - before
    assert launches3 == 1, launches3
    want = cuda_orient.orient_terms_levels_plain(rows, args)
    rel, err, near = compare_terms(got, want, corner_thresh,
                                   f"F1 kernel 3 {shape}")
    nb, o32, o64, _ = cuda_orient.orient_work_levels(rows, args)
    b, by = bound_ms(nb, o32, o64)
    k3 = dict(shape=shape, extents=ext, rows=len(zyx), launches=launches3,
              max_rel_err=rel, max_abs_err=err, near_threshold_rows=near,
              ms=cuda_ms(lambda: cuda_orient.orient_terms_levels(rows, args),
                         5),
              plain_ms=cuda_ms(lambda: cuda_orient.orient_terms_levels_plain(
                  rows, args), 1), bound_ms=b, bound_by=by)
    print(f"F1 orient_window on a {shape} level, table extents {ext} (box "
          f"walk), {len(zyx)} rows: {launches3} launch, max rel dev {rel:.3e} "
          f"(tolerance {ORIENT_RTOL}), {near} near-threshold rows; "
          f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.3f} ms, bound "
          f"{b:.5f} ms ({by}) [{CARD[0]}]")

    shape, sd = F1_K1
    level = torch.as_tensor(make_volume(shape, nblob=60,
                                        seed=SEED + 1)).to(dev)
    sigma, rad, radii, cores = fdesc.level_geometry(sd, RAW_UNITS, shape)
    assert cores[0] > 1024, cores
    centers = torch.tensor([[550.3, 3.6, 4.1], [2.0, 2.0, 2.0],
                            [1090.5, 5.2, 3.3], [700.0, 4.0, 4.0]],
                           device=dev)
    a = (level, centers, rotations(len(centers), SEED, dev), len(centers),
         radii, cores, RAW_UNITS, sigma, rad, None)
    before = launches("descrip_window")
    worst = check_descrip_window([(("F1", shape), a)], f"F1 core {cores}")
    launches1 = launches("descrip_window") - before
    assert launches1 == 1, launches1
    nb, ops, *_ = cuda_window.descrip_work(*a)
    b1, by1 = bound_ms(nb, ops)
    k1 = dict(shape=shape, cores=cores, rows=len(centers),
              launches=launches1, max_abs_err=worst,
              slabs=cuda_window.slab_plan(len(centers), cores[0])[1],
              ms=cuda_ms(lambda: cuda_window.descrip_window(*a), 5),
              plain_ms=cuda_ms(lambda: cuda_window.descrip_window_plain(*a),
                               1), bound_ms=b1, bound_by=by1)
    print(f"F1 descrip_window on a {shape} level, cores {cores} "
          f"({k1['slabs']} slabs a row), {len(centers)} rows: {launches1} "
          f"launch, max |dev| {worst:.3e} (tolerance {DESC_TOL}); "
          f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.3f} ms, bound "
          f"{b1:.5f} ms ({by1}) [{CARD[0]}]")
    return dict(k3=k3, k1=k1)


def dense_phase(src, dev) -> dict:
    """Config 3: ``Sift3D().dense`` at 512^3 against the committed golden
    of the C reference (``benches/make_dense_golden.py``), its time and
    peak memory by form, and the denseSift3D CLI on the 256^3 volume."""
    from benches.data import make_volume
    from sift3d_tpu_torch import api
    from sift3d_tpu_torch.cli import dense as cli_dense
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.features import dense as fdense
    from sift3d_tpu_torch.io import Volume, im_read, im_write
    from sift3d_tpu_torch.ops import conv
    from sift3d_tpu_torch.utils import trace

    golden = np.load(os.path.join(ROOT, DENSE_GOLDEN))
    n = DENSE_SIZE
    t0 = time.perf_counter()
    vol = make_volume((n,) * 3, nblob=max(60, n // 2), seed=SEED)
    gen_s = time.perf_counter() - t0
    params = SIFT3DParams()
    form = ("channel-sequential" if vol.size >= fdense.DENSE_CHANNEL_SEQ_VOX
            else "all at once")
    blur = "framed" if n >= conv.BANDED_MIN_N else "dense"
    s = api.Sift3D(params)
    trace.reset_counters()
    t0 = time.perf_counter()
    out = s.dense(vol)
    api_s = time.perf_counter() - t0
    counts = (launches("descrip_window"), launches("orient_window"))
    assert out.shape == (12, n, n, n) and out.dtype == np.float32
    assert np.isfinite(out).all()
    sub = out[:, ::DENSE_STRIDE, ::DENSE_STRIDE, ::DENSE_STRIDE]
    dev_sub = float(np.abs(sub - golden["sub"]).max())
    ch_mean = np.array([out[c].mean(dtype=np.float64) for c in range(12)])
    dev_mean = float(np.abs(ch_mean - golden["ch_mean"]).max())
    absmax = np.array([np.abs(out[c]).max() for c in range(12)])
    dev_absmax = float(np.abs(absmax - golden["ch_absmax"]).max())
    print(f"dense {n}^3 (config 3, {form}, {blur} blur: BANDED_MIN_N "
          f"{conv.BANDED_MIN_N}, FRAME_TILE {conv.FRAME_TILE}) vs the C "
          f"golden: stride-"
          f"{DENSE_STRIDE} subsample max |dev| {dev_sub:.3e}, channel means "
          f"{dev_mean:.3e} (tolerance {DESC_TOL}), channel |max| "
          f"{dev_absmax:.3e} (not asserted); launches descrip_window "
          f"{counts[0]} orient_window {counts[1]}")
    assert dev_sub <= DESC_TOL and dev_mean <= DESC_TOL

    vt = torch.as_tensor(vol).to(dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out_d, ms = event_ms(lambda: fdense.extract_dense_descriptors(
            vt, RAW_UNITS, params))
        runs.append((ms, torch.cuda.max_memory_allocated(dev) - base))
        del out_d
    seq_ms, seq_peak = min(runs)
    saved = fdense.DENSE_CHANNEL_SEQ_VOX
    fdense.DENSE_CHANNEL_SEQ_VOX = 1 << 62
    whole = dict(fits=False)
    try:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out_a, ms = event_ms(lambda: fdense.extract_dense_descriptors(
            vt, RAW_UNITS, params))
        peak = torch.cuda.max_memory_allocated(dev) - base
        dev_forms = float(np.abs(out_a.cpu().numpy() - out).max())
        whole = dict(fits=True, ms=ms, peak_bytes=peak,
                     max_abs_dev_from_seq=dev_forms)
        del out_a
    except torch.cuda.OutOfMemoryError as e:
        whole["error"] = str(e).splitlines()[0]
    finally:
        fdense.DENSE_CHANNEL_SEQ_VOX = saved
        torch.cuda.empty_cache()
    del out
    print(f"dense {n}^3: Sift3D.dense (numpy in and out) {api_s:.3f} s; "
          f"on the card {form} {seq_ms:.2f} ms by events, peak "
          f"{seq_peak / 1e9:.2f} GB above its input; all at once "
          + (f"{whole['ms']:.2f} ms, peak {whole['peak_bytes'] / 1e9:.2f} GB, "
             f"max |dev| from the {form} form {whole['max_abs_dev_from_seq']:.3e}"
             if whole["fits"] else f"does not fit ({whole['error']})")
          + f"; volume generated in {gen_s:.1f} s on the host [{CARD[0]}]")
    assert not whole["fits"] or whole["max_abs_dev_from_seq"] <= 2e-5

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        im_write(os.path.join(tmp, "src.nii"), Volume(src))
        trace.reset_counters()
        rc, t_cli = run_cli(cli_dense, [os.path.join(tmp, "src.nii"),
                                        os.path.join(tmp, "ch%.nii")], dev)
        cli_counts = (launches("descrip_window"), launches("orient_window"))
        assert rc == 0, rc
        chans = [im_read(os.path.join(tmp, f"ch{c}.nii")).data
                 for c in range(12)]
        assert not os.path.exists(os.path.join(tmp, "ch12.nii"))
    want = api.Sift3D(params).dense(src)
    cli_dev = max(float(np.abs(c - w).max()) for c, w in zip(chans, want))
    assert all(c.shape == src.shape for c in chans) and cli_dev <= 1e-6
    print(f"denseSift3D on the {SIZE}^3 image: 12 channel images, max |dev| "
          f"from Sift3D.dense {cli_dev:.3e}; wall {t_cli['wall']:.3f} s = "
          f"read {t_cli['read']:.3f} + compute {t_cli['compute']:.3f} + write "
          f"{t_cli['write']:.3f}; launches descrip_window {cli_counts[0]} "
          f"orient_window {cli_counts[1]} [{CARD[0]}]")
    return dict(form=form, blur=blur, counts=counts, api_s=api_s,
                ms=[r[0] for r in runs],
                peak_bytes=[r[1] for r in runs], all_at_once=whole,
                max_abs_dev_sub=dev_sub, max_abs_dev_mean=dev_mean,
                max_abs_dev_absmax=dev_absmax, volume_gen_s=gen_s,
                cli=dict(t_cli, counts=cli_counts, max_abs_dev=cli_dev)), vol


def rotate_phase(dev, corner_thresh) -> dict:
    """The rotate variant at ROT_SIZE^3 through ``Sift3D.dense`` (kernel 3
    one launch per ``DENSE_ORIENT_ROWS`` voxels, counted), its time split
    into orientation and histograms, and the field against the same
    function with the plain orientation, outside the voxels whose plain
    eigenvalue ratio or corner score lies within NEAR_THRESH of its
    threshold (counted)."""
    from benches.data import make_volume
    from sift3d_tpu_torch import api
    from sift3d_tpu_torch.config import SIFT3DParams
    from sift3d_tpu_torch.features import dense as fdense
    from sift3d_tpu_torch.ops import cuda_orient
    from sift3d_tpu_torch.utils import trace

    n = ROT_SIZE
    vol = make_volume((n,) * 3, nblob=max(60, n // 2), seed=SEED)
    params = SIFT3DParams(dense_rotate=True)
    V = vol.size
    expect = -(-V // fdense.DENSE_ORIENT_ROWS)
    trace.reset_counters()
    t0 = time.perf_counter()
    out = api.Sift3D(params).dense(vol)
    api_s = time.perf_counter() - t0
    counts = (launches("descrip_window"), launches("orient_window"))
    print(f"dense rotate {n}^3 through Sift3D.dense: {api_s:.3f} s; "
          f"launches descrip_window {counts[0]} orient_window {counts[1]} "
          f"(expected {expect}) [{CARD[0]}]")
    assert counts == (0, expect), counts
    assert out.shape == (12, n, n, n) and np.isfinite(out).all()

    vt = torch.as_tensor(vol).to(dev)
    smooth = fdense.smooth_scale_raw_input(vt, RAW_UNITS, params)
    (R_k, A_k, vd_k), orient_ms = event_ms(
        lambda: fdense.dense_orientations(smooth, RAW_UNITS, params))
    hist_k, hist_ms = event_ms(
        lambda: fdense.dense_rotate_histograms(smooth, R_k, RAW_UNITS,
                                               params))
    out_k = fdense.postproc_hist(hist_k, vt.reshape(-1))
    api_dev = float(np.abs(out_k.T.reshape(out.shape).cpu().numpy() -
                           out).max())
    assert api_dev <= 1e-6, api_dev
    (R_p, A_p, vd_p), orient_plain_ms = event_ms(
        lambda: fdense.dense_orientations(
            smooth, RAW_UNITS, params,
            terms=cuda_orient.orient_terms_levels_plain))
    rel, err, diff = compare_terms((A_k, vd_k), (A_p, vd_p), corner_thresh,
                                   f"rotate {n}^3", floor=ROT_TERM_FLOOR)
    near = near_threshold(A_p, vd_p, corner_thresh)
    out_p = fdense.postproc_hist(
        fdense.dense_rotate_histograms(smooth, R_p, RAW_UNITS, params),
        vt.reshape(-1))
    dev_vox = (out_k - out_p).abs().amax(1)
    far = float(dev_vox[~near].max())
    print(f"dense rotate {n}^3 vs the same function with the plain "
          f"orientation: max |dev| {far:.3e} (tolerance {DESC_TOL}) outside "
          f"{int(near.sum())} near-threshold voxels (their max |dev| "
          f"{float(dev_vox[near].max()) if near.any() else 0.0:.3e}); kernel "
          f"3 sums max rel dev {rel:.3e}, {diff} voxels whose orientation "
          f"differs")
    assert far <= DESC_TOL, far
    call = fdense.dense_orient_call(smooth, RAW_UNITS, params, 0,
                                    min(V, fdense.DENSE_ORIENT_ROWS))
    nb, o32, o64, active = cuda_orient.orient_work_levels(*call)
    b, by = bound_ms(nb, o32, o64)
    k3 = dict(rows=call[0].shape[0], max_rel_err=rel, max_abs_err=err,
              ms=cuda_ms(lambda: cuda_orient.orient_terms_levels(*call), 3),
              plain_ms=cuda_ms(lambda: cuda_orient.orient_terms_levels_plain(
                  *call), 1), bound_ms=b, bound_by=by, active_voxels=active)
    print(f"dense rotate {n}^3 times: orientation {orient_ms:.2f} ms (plain "
          f"{orient_plain_ms:.2f}), histograms {hist_ms:.2f} ms by events; "
          f"kernel 3 on {k3['rows']} rows {k3['ms']:.3f} ms by events (one "
          f"launch), plain {k3['plain_ms']:.1f} ms, bound {b:.5f} ms ({by}) "
          f"[{CARD[0]}]")
    return dict(counts=counts, rows=V, api_s=api_s, orient_ms=orient_ms,
                orient_plain_ms=orient_plain_ms, hist_ms=hist_ms,
                near_voxels=int(near.sum()), max_abs_dev=far, k3=k3)


def tps_fit_numpy(ctrl, targets, reg: float) -> np.ndarray:
    """(3, n + 4) params of the thin-plate spline through ``ctrl`` ->
    ``targets`` ((n, 3) float64 each) with ``reg`` on K's diagonal, solved
    by numpy on the host: the system of ``register/tps.fit_tps``, built
    independently of it."""
    n = len(ctrl)
    d = ctrl[:, None, :] - ctrl[None, :, :]
    r2 = np.sum(d * d, -1)
    K = np.where(r2 > 0, r2 * np.log(np.where(r2 > 0, r2, 1.0)), 0.0)
    K += reg * np.eye(n)
    P = np.concatenate([np.ones((n, 1)), ctrl], 1)
    L = np.block([[K, P], [P.T, np.zeros((4, 4))]])
    rhs = np.concatenate([targets, np.zeros((4, 3))], 0)
    return np.linalg.solve(L, rhs).T


def tps_phase(src, ref, dev) -> dict:
    """``RegSift3D().register_tps`` on the 256^3 pair (the spline against a
    numpy fit on the same inliers and its probe grid against the shift),
    the TPS warp at 256^3, and ``regSift3D --type tps`` on the pair's NIfTI
    files."""
    from benches.data import SHIFT, pair_ok
    from sift3d_tpu_torch import api
    from sift3d_tpu_torch.cli import reg as cli_reg
    from sift3d_tpu_torch.io import Volume, im_read, im_write
    from sift3d_tpu_torch.io.csv import read_tps
    from sift3d_tpu_torch.register.tps import im_inv_transform_tps, tps_apply
    from sift3d_tpu_torch.utils import trace

    reg = api.RegSift3D()
    trace.reset_counters()
    t0 = time.perf_counter()
    res, tps = reg.register_tps(src, ref, reg=TPS_REG)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    counts = (launches("descrip_window"), launches("orient_window"))
    assert res.ok and tps is not None and pair_ok(res.A), "register_tps"
    assert counts[1] == 2 and counts[0] > 0, counts
    inl = res.inlier_mask
    n_ctrl = int(tps.ctrl.shape[0])
    assert int(inl.sum()) == res.num_inliers == n_ctrl, (inl.sum(), n_ctrl)
    # Units are 1, so the matches' voxel coordinates are their mm.
    ref_in = res.match_ref[inl].astype(np.float64)
    src_in = res.match_src[inl].astype(np.float64)
    want = tps_fit_numpy(ref_in, src_in, TPS_REG)
    param_err = float(np.abs(tps.params.cpu().numpy() - want).max())
    ctrl_err = float(np.abs(tps.ctrl.cpu().numpy() - ref_in).max())
    at_ctrl = tps_apply(tps, tps.ctrl).cpu().numpy()
    interp_err = float(np.abs(at_ctrl - src_in).max())
    assert param_err <= TPS_PARAM_TOL and ctrl_err == 0.0, (param_err,
                                                            ctrl_err)
    assert interp_err <= TPS_CTRL_TOL, interp_err
    g = np.stack(np.meshgrid(*[TPS_PROBE] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float64)
    shift = np.array([-SHIFT, 0.0, 0.0])
    mapped = tps_apply(tps, torch.as_tensor(g, device=dev)).cpu().numpy()
    probe_dev = np.abs(mapped - (g + shift)).max(1)
    probe = float(probe_dev.max())
    inl_dev = np.abs(src_in - (ref_in + shift)).max(1)
    A_h = np.concatenate([g, np.ones((len(g), 1))], 1) @ res.A.T
    affine_probe = float(np.abs(A_h - (g + shift)).max())
    log(f"register_tps probe: max |dev| per point {np.round(probe_dev, 3)}; "
        f"inliers' |dev| from the shift max {inl_dev.max():.3f} mean "
        f"{inl_dev.mean():.3f}; the affine's probe |dev| {affine_probe:.3f}")
    bound = max(TPS_PROBE_TOL, float(inl_dev.max()))
    assert probe <= bound, (probe, bound)
    print(f"register_tps vs a float64 numpy fit on the same {n_ctrl} "
          f"inliers: params max |dev| {param_err:.3e} (tolerance "
          f"{TPS_PARAM_TOL}), control points exact, spline at them vs their "
          f"matched source points max |dev| {interp_err:.3e} mm (tolerance "
          f"{TPS_CTRL_TOL}); probe {probe:.3f} voxels, "
          f"{'within' if probe <= TPS_PROBE_TOL else 'NOT within'} "
          f"{TPS_PROBE_TOL} of the shift")
    src_d = torch.as_tensor(src).to(dev)
    warp_ms = min(event_ms(lambda: im_inv_transform_tps(tps, src_d))[1]
                  for _ in range(2))
    warped = im_inv_transform_tps(tps, src_d).cpu().numpy()
    inner = (slice(SIZE // 8, -SIZE // 8),) * 3
    warp_err = float(np.abs(warped[inner] - ref[inner]).mean())
    print(f"register_tps {SIZE}^3: ok, {len(res.match_src)} matches, "
          f"{res.num_inliers} inliers = {n_ctrl} control points, probe grid "
          f"max |dev| from the shift {probe:.3f} voxels (mean "
          f"{probe_dev.mean():.3f}; the affine's {affine_probe:.3f}; bound "
          f"{bound:.3f}: {TPS_PROBE_TOL} or the inliers' own max |dev| "
          f"{inl_dev.max():.3f}); "
          f"{reg_s:.3f} s host clock; launches descrip_window {counts[0]} "
          f"orient_window {counts[1]}; TPS warp {warp_ms:.2f} ms by events, "
          f"interior mean |warped - ref| {warp_err:.4f} [{CARD[0]}]")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        def f(name):
            return os.path.join(tmp, name)
        im_write(f("src.nii"), Volume(src))
        im_write(f("ref.nii"), Volume(ref))
        trace.reset_counters()
        rc, t_cli = run_cli(cli_reg, ["--type", "tps", "--transform",
                                      f("t.csv"), "--warped", f("w.nii"),
                                      f("src.nii"), f("ref.nii")], dev)
        cli_counts = (launches("descrip_window"), launches("orient_window"))
        assert rc == 0, rc
        params, ctrl = read_tps(f("t.csv"))
        assert params.shape == (3, len(ctrl) + 4) and len(ctrl) >= 5
        assert im_read(f("w.nii")).data.shape == ref.shape
    print(f"regSift3D --type tps on the {SIZE}^3 pair: {len(ctrl)} control "
          f"points; wall {t_cli['wall']:.3f} s = read {t_cli['read']:.3f} + "
          f"compute {t_cli['compute']:.3f} + write {t_cli['write']:.3f}; "
          f"launches descrip_window {cli_counts[0]} orient_window "
          f"{cli_counts[1]} [{CARD[0]}]")
    return dict(counts=counts, cli_counts=cli_counts, register_s=reg_s,
                matches=len(res.match_src), inliers=res.num_inliers,
                n_ctrl=n_ctrl, probe_max_dev=probe,
                probe_mean_dev=float(probe_dev.mean()),
                inlier_max_dev=float(inl_dev.max()), param_err=param_err,
                ctrl_interp_err=interp_err,
                affine_probe_max_dev=affine_probe, warp_ms=warp_ms,
                warp_interior_mean_err=warp_err, cli=t_cli)


def concat_descriptors(sets):
    """One batched Descriptors set of the volumes of several, padded to
    the largest capacity."""
    from sift3d_tpu_torch.features.descriptor import Descriptors
    K = max(d.capacity for d in sets)

    def cat(f):
        parts = [getattr(d, f) for d in sets]
        out = parts[0].new_zeros((sum(p.shape[0] for p in parts), K) +
                                 parts[0].shape[2:])
        b = 0
        for p in parts:
            out[b:b + p.shape[0], :p.shape[1]] = p
            b += p.shape[0]
        return out
    return Descriptors(xyz=cat("xyz"), sd=cat("sd"), vec=cat("vec"),
                       count=torch.cat([d.count for d in sets]))


def groupwise_numpy(edges, src, ref, cnt, inlier, n_vol: int,
                    ridge: float = 1e-9) -> np.ndarray:
    """(n_vol, 3, 4) affines minimizing sum |A_i [p; 1] - A_j [q; 1]|^2 over
    the inlier pairs of each edge (i, j), A_0 = I, built on the host from
    the objective's normal equations (one 4-row block per volume past 0,
    the three output rows as three right-hand sides) about the valid
    points' centroid, with ``ridge`` on the diagonal, and solved by numpy
    in float64."""
    M = src.shape[1]
    valid = np.arange(M) < cnt[:, None]
    c = (src[valid].sum(0) + ref[valid].sum(0)) / (2.0 * valid.sum())
    n = 4 * (n_vol - 1)
    H = np.zeros((n, n))
    rhs = np.zeros((n, 3))
    for e, (i, j) in enumerate(edges):
        m = inlier[e]
        hp = np.concatenate([src[e][m] - c, np.ones((m.sum(), 1))], 1)
        hq = np.concatenate([ref[e][m] - c, np.ones((m.sum(), 1))], 1)
        a, b = 4 * (i - 1), 4 * (j - 1)
        if i > 0:
            H[a:a + 4, a:a + 4] += hp.T @ hp
        if j > 0:
            H[b:b + 4, b:b + 4] += hq.T @ hq
        if i > 0 and j > 0:
            H[a:a + 4, b:b + 4] -= hp.T @ hq
            H[b:b + 4, a:a + 4] -= hq.T @ hp
        elif j > 0:                     # A_i = I: its rows are p's coords
            rhs[b:b + 4] += hq.T @ hp[:, :3]
        elif i > 0:
            rhs[a:a + 4] += hp.T @ hq[:, :3]
    X = np.linalg.solve(H + ridge * np.eye(n), rhs)
    A = np.zeros((n_vol, 3, 4))
    A[0] = np.eye(3, 4)
    for v in range(1, n_vol):
        L, t = X[4 * (v - 1):4 * v - 1].T, X[4 * v - 1]
        A[v, :, :3] = L
        A[v, :, 3] = t + c - L @ c
    return A


def fleet_deviation(A, want) -> tuple[float, float]:
    """Largest |linear - want| and |translation - want| over the fleet."""
    A, want = np.asarray(A), np.asarray(want)
    return (float(np.abs(A[:, :, :3] - want[:, :, :3]).max()),
            float(np.abs(A[:, :, 3] - want[:, :, 3]).max()))


def fleet_phase(base, dev, plan4, params4, k1_times, k3_times) -> dict:
    """Phase 9: groupwise registration of the config-5 fleet on the card;
    returns its record and (the fleet's descriptors, edges, A) for phase
    10.

    (a) 256 rolled copies of ``base`` (volume 0 unshifted), detected and
    described in 4 batches of 64, the 510 star + loop edges through
    ``register_groupwise``, held to the shifts and to a float64 numpy
    solve from the card's matches and inlier masks; (b) the synthetic
    config-5 correspondences of ``benches.data.make_fleet`` through a
    checkpoint store with a simulated preemption, solved by
    ``groupwise_solve``, held to their ground truth. The profile of one
    ``register_groupwise`` call comes last."""
    from benches.data import make_fleet
    from scripts.profile_register import profile_call
    from sift3d_tpu_torch.config import MatchParams, RansacParams
    from sift3d_tpu_torch.features import detect as detect_mod
    from sift3d_tpu_torch.features.orientation import levels_args
    from sift3d_tpu_torch.parallel.pipeline import batch_detect_describe
    from sift3d_tpu_torch.register import groupwise as gw
    from sift3d_tpu_torch.utils.checkpoint import GroupwiseCheckpoint
    from sift3d_tpu_torch.utils import trace
    from sift3d_tpu_torch.utils.trace import (StageTimer, jsonl_writer,
                                              set_log_fn)
    card = CARD[0]
    units = (1.0, 1.0, 1.0)
    rng = np.random.default_rng(FLEET_SEED)
    shifts = np.concatenate([np.zeros((1, 3), np.int64), rng.integers(
        -FLEET_SHIFT, FLEET_SHIFT + 1, (FLEET_VOLUMES - 1, 3))])
    vols = np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in shifts])
    edges, src5, ref5, cnt5, want5 = make_fleet(FLEET_VOLUMES)
    want = np.zeros((FLEET_VOLUMES, 3, 4))
    want[:, :, :3] = np.eye(3)
    want[:, :, 3] = -shifts[:, ::-1]            # zyx shifts, xyz columns
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    log_path = os.path.join(build, "fleet_trace.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    set_log_fn(jsonl_writer(log_path))
    timer = StageTimer("fleet")
    try:
        # (a) Detection, launches counted.
        trace.reset_counters()
        sets, expect_k1, overflow = [], 0, 0
        for c in range(0, FLEET_VOLUMES, FLEET_CHUNK):
            with timer.stage(f"detect_{c // FLEET_CHUNK}") as out:
                kp, desc, ov = batch_detect_describe(
                    vols[c:c + FLEET_CHUNK], plan4, params4, dev)
                out["set"] = (kp, desc, ov)
            sets.append(desc)
            expect_k1 += count_buckets(kp, {})[1]
            overflow += int(ov.sum())
        det_counts = (launches("descrip_window"), launches("orient_window"))
        n_chunks = FLEET_VOLUMES // FLEET_CHUNK
        kp_counts = torch.cat([d.count for d in sets]).cpu().numpy()
        print(f"fleet detection, {FLEET_VOLUMES} volumes in {n_chunks} "
              f"batches: launches orient_window {det_counts[1]} "
              f"descrip_window {det_counts[0]} (non-empty buckets "
              f"{expect_k1}), kp_overflow on {overflow} volumes, keypoints "
              f"per volume {kp_counts.min()}-{kp_counts.max()}")
        assert det_counts[1] == n_chunks, det_counts
        assert det_counts[0] == expect_k1, (det_counts, expect_k1)
        assert overflow == 0, f"kp_overflow on {overflow} fleet volumes"
        desc = concat_descriptors(sets)

        # Kernels 3 and 1 on the first batch against plain, and their times.
        gpyr, ext = extrema_of(vols[:FLEET_CHUNK], plan4, params4, dev)
        k3_call = [levels_args(detect_mod.keypoint_levels(gpyr, ext, plan4))]
        k3_check = check_orient_levels(k3_call, params4.corner_thresh,
                                       f"fleet batch, {FLEET_CHUNK} volumes")
        kp_flat, vol_flat = detect_mod.orient_levels(gpyr, ext, plan4,
                                                     params4)
        k1_args = level_args(gpyr, plan4, kp_flat, vol_flat)
        fullest = max(k1_args, key=lambda b: b[1][3])
        step = max(1, fullest[1][3] // BATCH_CHECK_ROWS)
        k1_check = [b for b in level_args(gpyr, plan4, kp_flat, vol_flat,
                                          step=step) if b[0] == fullest[0]]
        k1_worst = check_descrip_window(
            k1_check, f"fleet batch, one row in {step} of its fullest bucket")
        k1_t = k1_times(k1_args, 3)
        k3_t = k3_times(k3_call, 5)
        del gpyr, ext, kp_flat, vol_flat, k1_args, k1_check
        print(f"fleet batch kernels: descrip_window {k1_t['launches']} "
              f"launches {k1_t['ms']:.4f} ms, plain {k1_t['plain_ms']:.1f} "
              f"ms, bound {k1_t['bound_ms']:.4f} ms ({k1_t['bound_by']}); "
              f"orient_window 1 launch {k3_t['ms']:.4f} ms by events, alone "
              f"{fmt_ms(k3_t['alone_ms'])}, plain {k3_t['plain_ms']:.3f} ms, "
              f"bound {k3_t['bound_ms']:.5f} ms ({k3_t['bound_by']}) [{card}]")

        # The call, its stages, and the result against the shifts.
        res = gw.register_groupwise(desc, edges, units)
        torch.cuda.synchronize()
        assert launches("match_stream") == 0
        with timer.stage("match") as out:
            src, ref, cnt = gw._match_edges(desc, edges, units, MatchParams())
            out["m"] = (src, ref, cnt)
        with timer.stage("ransac") as out:
            n_in, inl = gw._ransac_edges(src, ref, cnt, RansacParams())
            out["r"] = (n_in, inl)
        with timer.stage("solve") as out:
            A_st = gw._solve_inliers(edges, src, ref, cnt, inl,
                                     FLEET_VOLUMES, 1e-9)
            out["A"] = A_st
        calls, As = [], []
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        for _ in range(3):
            with timer.stage("register_groupwise") as out:
                t0 = time.perf_counter()
                r = gw.register_groupwise(desc, edges, units)
                out["r"] = r
            calls.append((time.perf_counter() - t0) * 1e3)
            As.append(r.A)
        peak = torch.cuda.max_memory_allocated() - base_mem
        timer.report()
    finally:
        set_log_fn(None)
    spread = max(float((a - res.A).abs().max()) for a in As)
    A = res.A.cpu().numpy()
    cnt_h, inl_h = cnt.cpu().numpy(), inl.cpu().numpy()
    lin, trans = fleet_deviation(A, want)
    A_np = groupwise_numpy(edges, src.cpu().numpy(), ref.cpu().numpy(),
                           cnt_h, inl_h, FLEET_VOLUMES)
    np_dev = float(np.abs(A - A_np).max() / np.abs(A_np).max())
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        if rec["kind"] == "stage":
            print(f"fleet stage {rec['stage']}: {rec['seconds'] * 1e3:.3f} ms "
                  f"[{card}]")
    print(f"register_groupwise, {FLEET_VOLUMES} rolled copies of the "
          f"config-4 source volume, {len(edges)} star + loop edges: ok "
          f"{bool(res.ok)}, edges ok {int(res.edge_ok.sum())}, matches per "
          f"edge {cnt_h.min()}-{cnt_h.max()}, inliers per edge "
          f"{int(res.edge_inliers.min())}-{int(res.edge_inliers.max())}; max "
          f"|A - shift| linear {lin:.3e} translation {trans:.3f} (contract "
          f"{FLEET_LIN_TOL} / {FLEET_T_TOL}); vs a float64 numpy solve "
          f"{np_dev:.3e} of max |A| (tolerance {FLEET_SOLVE_RTOL}); A over 3 "
          f"more calls max |spread| {spread:.3e}; min of 3 {min(calls):.2f} "
          f"ms (host clock, ending in a sync), peak device memory "
          f"{peak / 2**20:.1f} MiB above the descriptors [{card}]")
    assert bool(res.ok) and bool(res.edge_ok.all()), "fleet not ok"
    assert np.array_equal(A[0], np.eye(3, 4)), A[0]
    assert lin <= FLEET_LIN_TOL and trans <= FLEET_T_TOL, (lin, trans)
    assert torch.equal(A_st, res.A) and torch.equal(n_in.int(),
                                                    res.edge_inliers)
    assert np.array_equal(inl_h.sum(1), res.edge_inliers.cpu().numpy())
    assert np_dev <= FLEET_SOLVE_RTOL, np_dev

    # RANSAC over the edges in chunks: equal bit for bit, time and memory.
    sweep = []
    for chunk in FLEET_SWEEP:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = gw._ransac_edges(src, ref, cnt, RansacParams(), chunk=chunk)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        assert torch.equal(out[0], n_in) and torch.equal(out[1], inl), chunk
        sweep.append(dict(chunk=chunk, ms=min(ms),
                          peak_bytes=torch.cuda.max_memory_allocated() - m0))
    M = src.shape[1]
    default_chunk = gw.edge_chunk(RansacParams(), M)
    print(f"RANSAC over {len(edges)} edges of {M} rows by chunk (edges: min "
          "of 2 ms, peak MiB): "
          + ", ".join(f"{s['chunk']}: {s['ms']:.2f}, "
                      f"{s['peak_bytes'] / 2**20:.0f}" for s in sweep)
          + f"; all equal bit for bit; default chunk {default_chunk} "
          f"[{card}]")

    # (b) The config-5 correspondences through the checkpoint store.
    params5 = RansacParams(num_iter=60)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ckpt = GroupwiseCheckpoint(os.path.join(tmp, "gw"))

        def run_matching(kill_after=None):
            done = 0
            for e, (i, j) in enumerate(edges):
                if ckpt.has(i, j):
                    continue
                ckpt.put(i, j, src5[e], ref5[e], cnt5[e])
                done += 1
                if kill_after is not None and done >= kill_after:
                    return False
            return True
        t0 = time.perf_counter()
        assert not run_matching(kill_after=FLEET_KILL_AFTER)
        assert len(ckpt.edges()) == FLEET_KILL_AFTER
        assert run_matching()
        src_c, ref_c, cnt_c = ckpt.gather([tuple(e) for e in edges])
        ckpt_s = time.perf_counter() - t0
    assert np.array_equal(src_c, src5) and np.array_equal(cnt_c, cnt5)
    solve5 = []
    for _ in range(3):
        t0 = time.perf_counter()
        res5 = gw.groupwise_solve(edges, src_c, ref_c, cnt_c, FLEET_VOLUMES,
                                  params5, device=dev)
        ok5 = bool(res5.ok)
        solve5.append((time.perf_counter() - t0) * 1e3)
    lin5, t5 = fleet_deviation(res5.A.cpu().numpy(), want5)
    print(f"groupwise_solve, config-5 correspondences ({len(edges)} edges "
          f"through the checkpoint store, preempted after "
          f"{FLEET_KILL_AFTER} and resumed, {ckpt_s:.3f} s): ok {ok5}, max "
          f"|A - truth| linear {lin5:.4f} translation {t5:.4f} (contract "
          f"{FLEET_LIN_TOL} / {FLEET_T_TOL}); min of 3 {min(solve5):.2f} ms "
          f"[{card}]")
    assert ok5 and lin5 <= FLEET_LIN_TOL and t5 <= FLEET_T_TOL, (ok5, lin5, t5)

    _, prof = profile_call(lambda: gw.register_groupwise(desc, edges, units))
    print("register_groupwise profiled (host span / device busy ms): "
          + ", ".join(f"{k} {v['host_ms']:.2f} / {v['device_busy_ms']:.2f}"
                      for k, v in prof["stages"].items())
          + f"; device busy {prof['device_busy_ms']:.2f} of "
          f"{prof['wall_ms']:.2f} ms, idle share {prof['idle_share']:.3f} "
          f"[{card}]")
    return (dict(counts=det_counts, expected_k1=expect_k1,
                kp_per_volume=[int(kp_counts.min()), int(kp_counts.max())],
                stages={r["stage"]: r["seconds"] for r in records
                        if r["kind"] == "stage"},
                register_ms=calls, peak_bytes=peak, profile=prof,
                lin_dev=lin, t_dev=trans, numpy_rel_dev=np_dev,
                run_spread=spread, sweep=sweep, default_chunk=default_chunk,
                k1=dict(k1_t, max_abs_err=k1_worst),
                k3=dict(k3_t, check=k3_check),
                config5=dict(lin_dev=lin5, t_dev=t5, solve_ms=solve5,
                             checkpoint_s=ckpt_s)),
            (desc, edges, res.A))


def blob_volume(shape_zyx, seed: int) -> np.ndarray:
    """A smooth volume of isotropic Gaussian blobs (the CPU tests'
    ``make_blob_volume``): max(40, voxels / 400) blobs."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape_zyx
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    vol = np.zeros(shape_zyx, np.float64)
    for _ in range(max(40, nz * ny * nx // 400)):
        cz, cy, cx = (rng.uniform(0, nz), rng.uniform(0, ny),
                      rng.uniform(0, nx))
        sig = rng.uniform(1.2, 4.0)
        amp = rng.uniform(-1.0, 1.0)
        vol += amp * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                            / (2 * sig * sig))
    return vol.astype(np.float32)


def f3_batch(dev):
    """prev, cur, nxt (2, 16, 12, 20) on ``dev``: volume 1 is volume 0's
    neighbour in the batch scaled by 10, so a threshold shared by the
    batch drops volume 0's extrema."""
    out = []
    for base in (1, 3, 5):
        v = np.stack([blob_volume(F3_SHAPE, base + 10 * b) for b in (0, 1)])
        v[1] *= F3_SCALE
        out.append(torch.as_tensor(v, device=dev))
    return out


def decisive_ssd() -> tuple[int, float]:
    """(A, nn_thresh): the best SSD A of the decisive query and a
    threshold with A / DECISIVE_B - nn_thresh^2 = 4e-10 in float64
    (reject) whose fp32 test accepts A (torch's and JAX's elementwise
    fp32: the square, the product, the comparison)."""
    for a in range(640_001, 641_000):
        t = float(np.sqrt(a / DECISIVE_B - 4e-10))
        reject64 = a > (t * t) * DECISIVE_B
        t2 = np.float32(t) * np.float32(t)
        accept32 = not np.float32(a) > t2 * np.float32(DECISIVE_B)
        if reject64 and accept32:
            return a, t
    raise AssertionError("no decisive SSD in range")


def _squares(n: int) -> list[int]:
    """Integers whose squares sum to n (greedy)."""
    out = []
    while n:
        k = int(np.sqrt(n))
        out.append(k)
        n -= k * k
    return out


def decisive_sets():
    """(src, ref) numpy descriptor fields (``xyz``, ``vec``) and
    nn_thresh: DECISIVE_GOOD rows that match their ref twins within fp32
    rounding, then the decisive query q (src row DECISIVE_GOOD) and its
    targets a (best, ref row DECISIVE_GOOD, placed at q's position) and b
    (second). float64 rejects q's row and fp32 accepts it."""
    rng = np.random.default_rng(21)
    A, t = decisive_ssd()
    n, half = DECISIVE_GOOD, np.arange(768) < 384
    good = rng.random((n, 768)) * half
    good /= np.linalg.norm(good, axis=1, keepdims=True)
    twin = good + rng.normal(0, 1e-3, good.shape) * half
    q = np.zeros(768)
    q[384] = np.sqrt(DECISIVE_Q2)
    alpha = np.zeros(768)
    parts = _squares(A)
    alpha[400:400 + len(parts)] = parts
    beta = np.zeros(768)
    beta[500] = np.sqrt(DECISIVE_B)
    src_vec = np.vstack([good, q]).astype(np.float32)
    ref_vec = np.vstack([twin, q + alpha, q + beta]).astype(np.float32)
    src_xyz = rng.uniform(5, 35, (n + 1, 3))
    ref_xyz = np.vstack([src_xyz - DECISIVE_SHIFT,
                         rng.uniform(5, 35, (1, 3))])
    return (dict(xyz=src_xyz, vec=src_vec), dict(xyz=ref_xyz, vec=ref_vec),
            t)


def mesh_phase(dev, src, plan, params, kp_src, d_src, d_ref, big, config4,
               phase5, fleet_state) -> dict:
    """Phase 10: the multi-GPU paths (``parallel/``, the sharded
    groupwise) at world size 1 under NCCL, through the port's
    ``init_distributed`` and ``make_mesh(data=1, space=1)``: (a) the
    sharded conv, extrema and windows on the 256^3 volume's pyramid
    against the one-device functions and kernels 3 and 1; (b) the
    sharded matchers, kernel 2 exactly twice a ``nn_match_sharded`` call;
    (c) ``batch_register_pairs(mesh=)`` on the config-4 batch against
    phase 5, then ``pipelined=True``; (d) ``register_groupwise_sharded``
    on phase 9's fleet and ``groupwise_solve_sharded`` on
    ``make_fleet(256)``; (e) times. The group is destroyed at the end."""
    import torch.distributed as dist
    from benches.data import make_fleet, pair_ok
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.config import MatchParams, RansacParams
    from sift3d_tpu_torch.features.descriptor import extract_level
    from sift3d_tpu_torch.features.detect import kp_levels, level_cap
    from sift3d_tpu_torch.features.extrema import (extrema_mask,
                                                   level_extrema)
    from sift3d_tpu_torch.features.match import nn_match
    from sift3d_tpu_torch.features.orientation import (
        orientations_from_tensor)
    from sift3d_tpu_torch.ops import conv, cuda_orient
    from sift3d_tpu_torch.ops.cuda_match import nn_match_streamed
    from sift3d_tpu_torch.parallel import (
        batch_register_pairs, conv_sep_sharded, descrip_level_sharded,
        init_distributed, level_extrema_sharded, make_mesh, nn_match_ring,
        nn_match_sharded, orient_level_sharded)
    from sift3d_tpu_torch.parallel.mesh import psum
    from sift3d_tpu_torch.parallel.pipeline import build_gpyr_batched
    from sift3d_tpu_torch.register import groupwise as gw
    from sift3d_tpu_torch.utils import trace
    card = CARD[0]
    src4, ref4, plan4, params4 = config4
    bres, batch_counts, batch_ms = phase5
    desc9, edges9, A9 = fleet_state
    out: dict = {}
    store = os.path.join(ROOT, "build", f"dist_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    init_distributed(f"file://{store}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = make_mesh(data=1, space=1)
        print(f"phase 10: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh (data, space) = "
              f"({mesh.data}, {mesh.space}) on {mesh.device}")

        # (a) Conv, extrema and windows at S = 1 on the 256^3 pyramid.
        gpyr, ext = extrema_of(src[None], plan, params, dev)
        dog = pyr.build_dog(gpyr, plan)
        conv_dev = 0.0
        for o in range(plan.num_octaves):
            for s in range(plan.first_level + 1, plan.last_gpyr_level + 1):
                x, taps = gpyr[(o, s - 1)], plan.octave_filter_taps(s)
                u = plan.octave_units(o)
                d = (conv_sep_sharded(x, taps, 1.0, u, mesh) -
                     conv.conv_sep(x, taps, 1.0, u)).abs().max().item()
                conv_dev = max(conv_dev, d)
        assert conv_dev <= CONV_TOL, conv_dev
        ext_rows = 0
        for o, s in kp_levels(plan):
            got = level_extrema_sharded(
                dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)],
                params.peak_thresh, level_cap(plan, o, params), mesh)
            want = ext[(o, s)]
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (o, s)
            ext_rows += want[0].shape[0]
        # F3: each volume against its own DoG max, as the one-device
        # detector; a max shared by the batch would drop volume 0's rows.
        f3 = f3_batch(dev)
        rows, count, total = level_extrema_sharded(*f3, F3_THRESH, F3_CAP,
                                                   mesh)
        f3_one = []
        for b in range(2):
            zyx, c, t = level_extrema(*(v[b] for v in f3), F3_THRESH, F3_CAP)
            assert int(count[b]) == c and int(total[b]) == t, (b, count, c)
            assert torch.equal(rows[rows[:, 0] == b, 1:], zyx), b
            f3_one.append(c)
        batch_max = f3[1].abs().amax().expand(2)
        shared = extrema_mask(*f3, F3_THRESH, dogmax=batch_max).sum(
            (1, 2, 3)).tolist()
        assert shared[0] < f3_one[0], (shared, f3_one)
        r_dev = 0.0
        near = n_orient = 0
        for (o, s), a in orient_args(gpyr, ext, plan, limit=N_CHECK_ROWS):
            A6, vd = cuda_orient.orient_terms(*a[:8], vol=a[8])
            R_k, ok_k = orientations_from_tensor(A6, vd, params.corner_thresh)
            R_s, ok_s = orient_level_sharded(
                a[0], a[1][None], plan.gpyr_level(o, s).scale,
                plan.octave_units(o), params.corner_thresh, mesh)
            R_s, ok_s = R_s[0], ok_s[0]
            nr = near_threshold(A6, vd, params.corner_thresh)
            bad = (ok_k != ok_s) & ~nr
            assert not bad.any(), f"orient_level_sharded {(o, s)}: {bad}"
            both = ok_k & ok_s
            if both.any():
                r_dev = max(r_dev, (R_k[both] - R_s[both]).abs().max().item())
            near += int((ok_k != ok_s).sum())
            n_orient += a[2]
        assert r_dev <= SHARD_R_TOL, r_dev
        d_dev = 0.0
        n_desc = 0
        for (o, s), a in level_args(gpyr, plan, kp_src, limit=N_CHECK_ROWS):
            level, centers, R = a[0], a[1], a[2]
            u, scale = plan.octave_units(o), plan.gpyr_level(o, s).scale
            want = extract_level(level, centers, R, scale, u)
            got = descrip_level_sharded(level, centers[None], R[None], scale,
                                        u, mesh)[0]
            d_dev = max(d_dev, (got - want).abs().max().item())
            n_desc += a[3]
        assert d_dev <= DESC_TOL, d_dev
        print(f"phase 10 (a) at S = 1 on the {SIZE}^3 pyramid: "
              f"conv_sep_sharded vs conv_sep max |dev| {conv_dev:.3e} "
              f"(tolerance {CONV_TOL}); level_extrema_sharded equal to "
              f"level_extrema on {len(kp_levels(plan))} levels ({ext_rows} "
              f"rows); F3 batch (2 x {F3_SHAPE}, volume 1 x {F3_SCALE:g}): "
              f"level_extrema_sharded counts {count.tolist()} equal to "
              f"level_extrema volume by volume {f3_one}, rows equal (a "
              f"threshold shared by the batch would give {shared}); "
              f"orient_level_sharded vs kernel 3 on {n_orient} rows: "
              f"valid equal except {near} near-threshold rows, R max |dev| "
              f"{r_dev:.3e} (tolerance {SHARD_R_TOL}); descrip_level_sharded "
              f"vs kernel 1 on {n_desc} rows: max |dev| {d_dev:.3e} "
              f"(tolerance {DESC_TOL})")
        out["a"] = dict(conv_dev=conv_dev, extrema_rows=ext_rows,
                        f3_counts=f3_one, f3_shared_counts=shared,
                        orient_rows=n_orient, orient_near=near,
                        orient_r_dev=r_dev, desc_rows=n_desc, desc_dev=d_dev)

        # (b) The sharded matchers: kernel 2 twice a nn_match_sharded call.
        thresh = MatchParams().nn_thresh
        ones = [torch.ones(x.shape[0], dtype=torch.bool, device=dev)
                for x in big]
        sets = {f"{SIZE}^3 pair": (d_src.vec, d_ref.vec, d_src.valid_mask(),
                                   d_ref.valid_mask()),
                "2500x2300": (big[0], big[1], ones[0], ones[1])}
        out["b"] = {}
        for label, (a, b, va, vb) in sets.items():
            before = launches("match_stream")
            m_sh = nn_match_sharded(a, b, thresh, mesh, valid1=va, valid2=vb,
                                    streamed=True)
            torch.cuda.synchronize()
            launches2 = launches("match_stream") - before
            assert launches2 == 2, launches2
            m_ring = nn_match_ring(a, b, thresh, mesh, valid1=va, valid2=vb)
            m_str = nn_match_streamed(a, b, thresh, va, vb)
            m_dense = nn_match(a, b, thresh, va, vb)
            n_diff = [same_matches(a, b, va, vb, m_sh, m_str,
                                   f"{label} sharded vs streamed"),
                      same_matches(a, b, va, vb, m_sh, m_dense,
                                   f"{label} sharded vs dense"),
                      same_matches(a, b, va, vb, m_ring, m_dense,
                                   f"{label} ring vs dense")]
            # F2: the dense branch and the ring in float64 against the
            # one-device matcher in float64.
            m64 = nn_match(a, b, thresh, va, vb, dtype=torch.float64)
            s64 = nn_match_sharded(a, b, thresh, mesh, valid1=va, valid2=vb,
                                   dtype=torch.float64, streamed=False)
            r64 = nn_match_ring(a, b, thresh, mesh, valid1=va, valid2=vb,
                                dtype=torch.float64)
            n64 = [same_matches(a, b, va, vb, s64, m64,
                                f"{label} sharded float64 vs nn_match "
                                f"float64"),
                   same_matches(a, b, va, vb, r64, m64,
                                f"{label} ring float64 vs nn_match float64")]
            vs32 = int((m64 != m_dense).sum())
            print(f"phase 10 (b) {label} float64: nn_match_sharded(dtype="
                  f"float64, streamed=False) and nn_match_ring(dtype="
                  f"float64) against nn_match(dtype=float64): rows "
                  f"differing {n64}; {int((m64 >= 0).sum())} matches, "
                  f"{vs32} rows differ from float32's")
            out["b"][label] = dict(launches=launches2,
                                   matches=int((m_sh >= 0).sum()),
                                   near_tie_rows=n_diff,
                                   float64_rows_differing=n64,
                                   float64_matches=int((m64 >= 0).sum()),
                                   float64_vs_float32_rows=vs32)
            print(f"phase 10 (b) {label} ({a.shape[0]}x{b.shape[0]}): "
                  f"nn_match_sharded(streamed=True) launched match_stream "
                  f"{launches2} times, {int((m_sh >= 0).sum())} matches; rows "
                  f"differing from nn_match_streamed / dense, and ring from "
                  f"dense, all near-ties: {n_diff}")
        # F2 decides here: on the decisive sets float64 rejects the row
        # that fp32 accepts, in the one-device matcher and both sharded
        # ones.
        src_d, ref_d, t_d = decisive_sets()
        a, b = (torch.as_tensor(d["vec"], device=dev) for d in (src_d, ref_d))
        va, vb = (torch.ones(x.shape[0], dtype=torch.bool, device=dev)
                  for x in (a, b))
        q = DECISIVE_GOOD
        out["b_decisive"] = {}
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[-1]
            want = list(range(q)) + [q if dt == torch.float32 else -1]
            got = {"nn_match": nn_match(a, b, t_d, va, vb, dtype=dt),
                   "nn_match_sharded": nn_match_sharded(
                       a, b, t_d, mesh, valid1=va, valid2=vb, dtype=dt,
                       streamed=False),
                   "nn_match_ring": nn_match_ring(
                       a, b, t_d, mesh, valid1=va, valid2=vb, dtype=dt)}
            for fn, m in got.items():
                assert m.tolist() == want, \
                    f"decisive sets, {fn} {name}: {m.tolist()}, want {want}"
            out["b_decisive"][name] = int(got["nn_match_ring"][q])
        print(f"phase 10 (b) decisive sets ({a.shape[0]}x{b.shape[0]}, "
              f"nn_thresh {t_d!r}): nn_match, nn_match_sharded(streamed="
              f"False) and nn_match_ring match query {q} to "
              f"{out['b_decisive']['float32']} in float32 and "
              f"{out['b_decisive']['float64']} in float64, rows 0-{q - 1} "
              f"to their twins")
        args = (big[0], big[1], thresh)
        out["b"]["sharded_ms"] = cuda_ms(
            lambda: nn_match_sharded(*args, mesh, streamed=True), 5)
        out["b"]["streamed_ms"] = cuda_ms(
            lambda: nn_match_streamed(*args), 5)
        k2_names = ("match_top2_kernel", "merge_ranges_kernel")
        out["b"]["sharded_kernel_ms"] = kernel_alone_ms(
            lambda: nn_match_sharded(*args, mesh, streamed=True), k2_names, 5)
        out["b"]["streamed_kernel_ms"] = kernel_alone_ms(
            lambda: nn_match_streamed(*args), k2_names, 5)
        print(f"nn_match_sharded(streamed=True) at 2500x2300, S = 1: "
              f"{out['b']['sharded_ms']:.4f} ms against nn_match_streamed "
              f"{out['b']['streamed_ms']:.4f} ms (mean of 5 by events); "
              f"kernel 2 alone (both directions, range merges included) "
              f"{fmt_ms(out['b']['sharded_kernel_ms'])} a call inside "
              f"nn_match_sharded, {fmt_ms(out['b']['streamed_kernel_ms'])} "
              f"inside nn_match_streamed [{card}]")

        # (c) batch_register_pairs over the mesh against phase 5.
        trace.reset_counters()
        mres = batch_register_pairs(src4, ref4, plan4, params4, device=dev,
                                    mesh=mesh)
        torch.cuda.synchronize()
        counts = tuple(launches(k) for k in KERNELS_1_2_3)
        A_m, A_5 = mres.A.cpu().numpy(), bres.A.cpu().numpy()
        a_dev = float(np.nanmax(np.abs(A_m - A_5)))
        rate = float((mres.ok.cpu().numpy() & pair_ok(A_m)).mean())
        n_over = int(mres.kp_overflow.sum())
        print(f"phase 10 (c) batch_register_pairs(mesh=), {len(src4)} "
              f"config-4 pairs: launches descrip_window {counts[0]} "
              f"match_stream {counts[1]} orient_window {counts[2]} (phase 5: "
              f"{tuple(batch_counts)}), kp_overflow on {n_over}, pass rate "
              f"{rate:.3f}, max |A - phase 5's A| {a_dev:.3e}")
        assert counts == tuple(batch_counts), (counts, batch_counts)
        assert n_over == 0 and rate >= GATE_PASS_RATE, (n_over, rate)
        assert a_dev <= 1e-6 and np.array_equal(np.isnan(A_m),
                                                np.isnan(A_5)), a_dev
        scaled = pyr.im_scale(torch.as_tensor(src4).to(dev))
        seq = pyr.build_gpyr(scaled, plan4)
        pip = build_gpyr_batched(scaled, plan4, mesh, pipelined=True)
        pip_dev = max((pip[k] - v).abs().max().item() for k, v in seq.items())
        del seq, pip, scaled
        pres = batch_register_pairs(src4, ref4, plan4, params4, device=dev,
                                    mesh=mesh, pipelined=True)
        A_p = pres.A.cpu().numpy()
        p_rate = float((pres.ok.cpu().numpy() & pair_ok(A_p)).mean())
        print(f"phase 10 (c) pipelined=True: levels of the first batch max "
              f"|dev| from sequential {pip_dev:.3e} (tolerance 2e-6), pass "
              f"rate {p_rate:.3f}, kp_overflow on "
              f"{int(pres.kp_overflow.sum())} pairs")
        assert pip_dev <= 2e-6 and p_rate >= GATE_PASS_RATE, (pip_dev,
                                                              p_rate)
        # The call with and without the mesh in turns (one, mesh, mesh,
        # one, ...): host clocks drift over the script's phases.
        calls = {"one": [], "mesh": []}
        for i in range(10):
            label = ("one", "mesh")[(i + i // 2) % 2]
            t0 = time.perf_counter()
            batch_register_pairs(src4, ref4, plan4, params4, device=dev,
                                 mesh=mesh if label == "mesh" else None)
            torch.cuda.synchronize()
            calls[label].append((time.perf_counter() - t0) * 1e3)
        n = len(src4)
        t_mesh, t_one = min(calls["mesh"]), min(calls["one"])
        print(f"batch_register_pairs ({n} config-4 pairs, S = 1), in turns "
              f"with and without the mesh, min of 5 each: mesh "
              f"{t_mesh:.2f} ms ({n / t_mesh * 1e3:.2f} pairs/s, median "
              f"{np.median(calls['mesh']):.2f}), one device {t_one:.2f} ms "
              f"({n / t_one * 1e3:.2f} pairs/s, median "
              f"{np.median(calls['one']):.2f}); phase 6's min of 5 without "
              f"a mesh {batch_ms:.2f} ms [{card}]")
        out["c"] = dict(counts=counts, a_dev=a_dev, pass_rate=rate,
                        pipelined_dev=pip_dev, pipelined_pass_rate=p_rate,
                        mesh_ms=calls["mesh"], one_device_ms=calls["one"],
                        phase6_ms=batch_ms)

        # (d) Groupwise over the mesh against phase 9.
        units = (1.0, 1.0, 1.0)
        res = gw.register_groupwise_sharded(desc9, edges9, units, mesh)
        A = res.A.cpu().numpy()
        A9n = A9.cpu().numpy()
        gw_dev = float(np.abs(A - A9n).max() / np.abs(A9n).max())
        assert bool(res.ok) and bool(res.edge_ok.all()), "fleet not ok"
        assert gw_dev <= FLEET_SOLVE_RTOL, gw_dev
        edges5, src5, ref5, cnt5, want5 = make_fleet(FLEET_VOLUMES)
        r5 = gw.groupwise_solve_sharded(
            edges5, src5, ref5, cnt5, FLEET_VOLUMES, mesh,
            ransac_params=RansacParams(num_iter=60))
        lin5, t5 = fleet_deviation(r5.A.cpu().numpy(), want5)
        assert bool(r5.ok) and lin5 <= FLEET_LIN_TOL and t5 <= FLEET_T_TOL, \
            (bool(r5.ok), lin5, t5)

        def host_ms(fn):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return min(ts)
        t_sh = host_ms(lambda: gw.register_groupwise_sharded(
            desc9, edges9, units, mesh))
        t_one = host_ms(lambda: gw.register_groupwise(desc9, edges9, units))
        H = torch.zeros((FLEET_VOLUMES - 1,) * 2 + (4, 4), dtype=torch.float64,
                        device=dev)
        t_ar = cuda_ms(lambda: psum(H, mesh, "data"), 20)
        print(f"phase 10 (d) register_groupwise_sharded on phase 9's "
              f"{FLEET_VOLUMES} sets and {len(edges9)} edges: ok, every edge "
              f"ok, A within {gw_dev:.3e} of phase 9's (tolerance "
              f"{FLEET_SOLVE_RTOL}); groupwise_solve_sharded on "
              f"make_fleet({FLEET_VOLUMES}): ok, |A - truth| linear "
              f"{lin5:.4f} translation {t5:.4f}")
        print(f"register_groupwise_sharded min of 3 {t_sh:.2f} ms against "
              f"register_groupwise {t_one:.2f} ms (host clock, ending in a "
              f"sync); world-1 all_reduce of the {FLEET_VOLUMES - 1}x"
              f"{FLEET_VOLUMES - 1}x4x4 float64 system "
              f"({H.numel() * 8 / 2**20:.2f} MiB) {t_ar:.4f} ms (mean of 20 "
              f"by events) [{card}]")
        out["d"] = dict(rel_dev=gw_dev, lin5=lin5, t5=t5, sharded_ms=t_sh,
                        one_device_ms=t_one, all_reduce_ms=t_ar)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return out


def printed_affines(lines, prefix) -> list[np.ndarray]:
    """Every 3x4 array that an example printed on the lines after a line
    starting with ``prefix``."""
    out = []
    for i, line in enumerate(lines):
        if line.startswith(prefix):
            text = ""
            for row in lines[i + 1:]:
                text += " " + row
                if row.rstrip().endswith("]]"):
                    break
            vals = text.replace("[", " ").replace("]", " ").split()
            out.append(np.array([float(v) for v in vals]).reshape(3, 4))
    return out


def run_example(name, args) -> tuple[list[str], float]:
    """``python examples/torch/<name>.py ARGS`` from the repo root with
    ``PYTHONPATH`` at it, as a user runs it: its printed lines and wall
    seconds. Fails unless it exits 0."""
    script = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, script, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        log(r.stdout)
        log(r.stderr)
        raise AssertionError(f"examples/torch/{name}.py exited "
                             f"{r.returncode}")
    return r.stdout.splitlines(), wall


def examples_phase(src, ref, dev) -> dict:
    """Phase 12: the five examples as subprocesses on NIfTI files under
    ``build/``: features.py, io.py, register.py and nonrigid.py on the
    256^3 pair, groupwise.py on four rolled 128^3 volumes. Each must exit
    0: features.py prints the keypoint count of an in-process
    ``Sift3D().detect`` of the same file, io.py's output reads back equal
    to its input, register.py's A is inside the 5e-2 / 5-voxel contract of
    the known shift, nonrigid.py writes a volume of the reference's shape,
    groupwise.py's A's are inside the contract of the known rolls."""
    from benches.data import make_volume, pair_ok
    from sift3d_tpu_torch import Sift3D
    from sift3d_tpu_torch.io import Volume, im_read, im_write
    card = CARD[0]
    d = tempfile.mkdtemp(prefix="examples_", dir=os.path.join(ROOT, "build"))
    out: dict = {"wall_s": {}}
    wall = out["wall_s"]
    try:
        p = {k: os.path.join(d, f"{k}.nii") for k in ("src", "ref")}
        im_write(p["src"], Volume(src))
        im_write(p["ref"], Volume(ref))
        base = make_volume((EXAMPLE_GW_SIZE,) * 3, nblob=EXAMPLE_GW_NBLOB,
                           seed=SEED)
        gw = []
        for i, r in enumerate(EXAMPLE_GW_ROLLS):
            gw.append(os.path.join(d, f"g{i}.nii"))
            im_write(gw[-1], Volume(np.roll(base, r, (0, 1, 2))))

        lines, wall["features"] = run_example("features", [p["src"]])
        n_kp = int(Sift3D(device=dev).detect(im_read(p["src"])).count)
        assert f"detected {n_kp} keypoints" in lines, (n_kp, lines)
        out["features_keypoints"] = n_kp

        io_out = os.path.join(d, "io_out.nii.gz")
        lines, wall["io"] = run_example("io", [p["src"], io_out])
        back, orig = im_read(io_out), im_read(p["src"])
        assert np.array_equal(back.data, orig.data), "io.py round trip"
        assert back.units == orig.units, (back.units, orig.units)

        warped = os.path.join(d, "warped.nii")
        lines, wall["register"] = run_example(
            "register", [p["src"], p["ref"], warped])
        A = printed_affines(lines, "affine (ref -> src voxels):")
        assert len(A) == 1 and pair_ok(A[0]), A
        assert im_read(warped).data.shape == ref.shape
        out["register_A"] = A[0].tolist()

        nonrigid = os.path.join(d, "nonrigid.nii")
        lines, wall["nonrigid"] = run_example(
            "nonrigid", [p["src"], p["ref"], nonrigid])
        w = im_read(nonrigid).data
        assert w.shape == ref.shape and np.isfinite(w).all(), w.shape
        out["nonrigid_line"] = lines[-1]

        lines, wall["groupwise"] = run_example("groupwise", gw)
        A = np.stack(printed_affines(lines, "A["))
        want = np.zeros_like(A)
        want[:, :, :3] = np.eye(3)
        want[:, :, 3] = -np.asarray(EXAMPLE_GW_ROLLS, np.float64)[:, ::-1]
        lin, t = fleet_deviation(A, want)
        assert len(A) == len(gw) and lin < 5e-2 and t < 5.0, (lin, t)
        out["groupwise_dev"] = [lin, t]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase 12 examples/torch/*.py as subprocesses: features.py "
          f"{n_kp} keypoints as Sift3D().detect; io.py round trip equal; "
          f"register.py A inside the contract (translation "
          f"{np.round(out['register_A'], 4)[:, 3].tolist()}); nonrigid.py "
          f"\"{out['nonrigid_line']}\", warped {ref.shape}; groupwise.py on "
          f"{len(gw)} {EXAMPLE_GW_SIZE}^3 volumes: |A - truth| linear "
          f"{lin:.4f} translation {t:.4f}")
    print("phase 12 wall seconds a subprocess (start, imports and file I/O "
          "included): " + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
          + f" [{card}]")
    return out


def ext_margin(dog, key, rows, peak_thresh):
    """Each extrema row's (vol, z, y, x) margin on DoG level ``key``: the
    least of |value| - threshold and its |difference| from the 8 values
    it is compared with (``features/extrema.extrema_mask``)."""
    o, s = key
    prev, cur, nxt = dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)]
    b, z, y, x = rows.long().T
    c = cur[b, z, y, x]
    m = c.abs() - peak_thresh * cur.abs().amax(dim=(-3, -2, -1))[b]
    for nb in (prev[b, z, y, x], nxt[b, z, y, x], cur[b, z, y, x + 1],
               cur[b, z, y, x - 1], cur[b, z, y + 1, x], cur[b, z, y - 1, x],
               cur[b, z + 1, y, x], cur[b, z - 1, y, x]):
        m = torch.minimum(m, (c - nb).abs())
    return m


def compare_detections(runs, plan, params) -> dict:
    """Two detections of one volume (``extrema_of``'s pyramid and rows,
    one a form): the extrema rows of each level equal except rows whose
    margin, in the detection that has them, is within twice the level's
    DoG deviation between the two (only those can change side); on the
    rows both have, kernel 3's ``valid`` equal except near-threshold rows
    (counted) and R within SHARD_R_TOL where both are valid."""
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.features.detect import kp_levels
    from sift3d_tpu_torch.features.orientation import orientations_from_tensor
    from sift3d_tpu_torch.ops import cuda_orient
    (g1, e1), (g2, e2) = runs
    d1, d2 = pyr.build_dog(g1, plan), pyr.build_dog(g2, plan)
    common: dict = {}
    n_diff = n_rows = 0
    level_dev = 0.0
    for key in kp_levels(plan):
        o, s = key
        dev_ = max((d1[(o, t)] - d2[(o, t)]).abs().max().item()
                   for t in (s - 1, s, s + 1))
        level_dev = max(level_dev, dev_)
        r1, r2 = e1[key][0], e2[key][0]
        t1 = {tuple(r) for r in r1.tolist()}
        t2 = {tuple(r) for r in r2.tolist()}
        for dog, rows, other in ((d1, r1, t2), (d2, r2, t1)):
            only = torch.tensor([r for r in rows.tolist()
                                 if tuple(r) not in other],
                                dtype=torch.long, device=rows.device)
            if only.numel():
                m = ext_margin(dog, key, only, params.peak_thresh)
                assert (m <= 2 * dev_).all(), \
                    f"extrema {key}: rows {only.tolist()} margins {m.tolist()}"
                n_diff += only.shape[0]
        keep = torch.tensor([tuple(r) in t2 for r in r1.tolist()],
                            dtype=torch.bool, device=r1.device)
        common[key] = (r1[keep],)
        n_rows += int(keep.sum())
    near = n_orient = 0
    r_dev = 0.0
    got = [dict(orient_args(g, common, plan)) for g in (g1, g2)]
    for key, a1 in got[0].items():
        out = []
        for a in (a1, got[1][key]):
            A6, vd = cuda_orient.orient_terms(*a[:8], vol=a[8])
            out.append((A6, vd) + orientations_from_tensor(
                A6, vd, params.corner_thresh))
        (A1, v1, R1, ok1), (A2, v2, R2, ok2) = out
        nr = near_threshold(A1, v1, params.corner_thresh) | \
            near_threshold(A2, v2, params.corner_thresh)
        bad = (ok1 != ok2) & ~nr
        assert not bad.any(), f"orientation {key}: {int(bad.sum())} rows"
        both = ok1 & ok2
        if both.any():
            r_dev = max(r_dev, (R1[both] - R2[both]).abs().max().item())
        near += int((ok1 != ok2).sum())
        n_orient += a1[2]
    assert r_dev <= SHARD_R_TOL, r_dev
    return dict(dog_dev=level_dev, extrema_rows_differing=n_diff,
                common_rows=n_rows, orient_rows=n_orient,
                orient_near=near, orient_r_dev=r_dev)


def pyramid_flops(plan, banded_min_n: int) -> float:
    """The matmul FLOPs of one ``build_gpyr`` with the framed form from
    ``banded_min_n``: 2 n a voxel and axis dense, 2 K = 2 (T + 2H)
    framed."""
    from sift3d_tpu_torch.ops import conv
    total = 0.0
    for o in range(plan.num_octaves):
        dims = plan.octave_dims(o)
        vox = float(np.prod(dims))
        blurs = [(plan.first_gauss_taps(), plan.octave_units(0))] if o == 0 \
            else []
        blurs += [(plan.octave_filter_taps(s), plan.octave_units(o))
                  for s in range(plan.first_level + 1,
                                 plan.last_gpyr_level + 1)]
        for taps, units in blurs:
            for n, u in zip(dims, units):
                if n >= banded_min_n:
                    _, tiles = conv.banded_frame_tiles(
                        conv.conv_matrix(taps, 1.0, u, n))
                    total += 2.0 * tiles.shape[2] * vox
                else:
                    total += 2.0 * n * vox
    return total


def banded_phase(dev, src, ref, plan, params, vol512) -> dict:
    """Phase 11: the convolution's crossover on the card
    (``scripts/conv_banded_ab.py``), the committed ``BANDED_MIN_N`` and
    ``FRAME_TILE`` held to the rule's choice, and the paths the choice
    reaches with the form forced by the module constant (restored after
    each block)."""
    from benches.data import pair_ok
    from scripts.conv_banded_ab import (SENTINEL, banded_min_n,
                                        check_composed, crossover, pick)
    from scripts.profile_register import profile_call
    from sift3d_tpu_torch import RegSift3D
    from sift3d_tpu_torch.features import dense as fdense
    from sift3d_tpu_torch.ops import conv
    from sift3d_tpu_torch.utils.roofline import H100_SXM
    card = CARD[0]
    rows = crossover(dev)
    composed = check_composed(dev)
    rule = pick(rows)
    committed = (conv.BANDED_MIN_N, conv.FRAME_TILE)
    print(f"phase 11 rule on this table: BANDED_MIN_N {rule[0]}, "
          f"FRAME_TILE {rule[1]}; committed {committed[0]}, {committed[1]} "
          f"[{card}]")
    assert rule == committed, \
        f"this card's table picks {rule}, not the committed {committed}"

    # Detection of the 256^3 volume framed and dense; the pair framed.
    det = []
    for n in (1, SENTINEL):
        with banded_min_n(n):
            det.append(extrema_of(src[None], plan, params, dev))
    cmp_ = compare_detections(det, plan, params)
    del det
    with banded_min_n(1):
        res = RegSift3D(device=dev).register(src, ref)
    ok = bool(res.ok and pair_ok(res.A) and not res.kp_overflow)
    print(f"detection {SIZE}^3 framed vs dense: DoG max |dev| "
          f"{cmp_['dog_dev']:.3e}; extrema rows differing "
          f"{cmp_['extrema_rows_differing']} (each within twice the DoG "
          f"deviation of its test), {cmp_['common_rows']} rows in both; "
          f"orientation valid equal except {cmp_['orient_near']} "
          f"near-threshold rows of {cmp_['orient_rows']}, R max |dev| "
          f"{cmp_['orient_r_dev']:.3e} (tolerance {SHARD_R_TOL}); register "
          f"framed: ok={ok}, matches {len(res.match_src)}, inliers "
          f"{res.num_inliers}, A={np.round(res.A, 4).tolist()}")
    assert ok, "the framed 256^3 pair is outside the contract"

    # The 256^3 register and config 3 at 512^3, each setting in turns.
    settings = {"committed": conv.BANDED_MIN_N, "dense": SENTINEL,
                "framed": 1}
    reg = RegSift3D(device=dev)
    reg_ms = {k: [] for k in settings}
    for k, n in settings.items():
        with banded_min_n(n):
            reg.register(src, ref)
    for _ in range(5):
        for k, n in settings.items():
            with banded_min_n(n):
                t0 = time.perf_counter()
                reg.register(src, ref)
                torch.cuda.synchronize()
                reg_ms[k].append((time.perf_counter() - t0) * 1e3)
    pyr_stage = {}
    for k, n in settings.items():
        with banded_min_n(n):
            _, prof = profile_call(lambda: reg.register(src, ref))
        flops = 2 * pyramid_flops(plan, n)
        busy = prof["stages"]["pyramid"]["device_busy_ms"]
        pyr_stage[k] = dict(
            host_ms=prof["stages"]["pyramid"]["host_ms"], device_busy_ms=busy,
            flops=flops, floor_ms=flops / (H100_SXM.fp32_tflops * 1e12) * 1e3,
            tflops=flops / busy / 1e9, idle_share=prof["idle_share"])
    for k in settings:
        p = pyr_stage[k]
        print(f"register {SIZE}^3 {k} (BANDED_MIN_N {settings[k]}): min of 5 "
              f"{min(reg_ms[k]):.2f} ms, median {np.median(reg_ms[k]):.2f}; "
              f"pyramid span host {p['host_ms']:.2f} / device busy "
              f"{p['device_busy_ms']:.2f} ms for {p['flops'] / 1e9:.1f} GFLOP "
              f"of matmul (floor {p['floor_ms']:.3f} ms at "
              f"{H100_SXM.fp32_tflops:g} TFLOP/s, {p['tflops']:.2f} TFLOP/s "
              f"of busy time), idle share {p['idle_share']:.3f} [{card}]")

    vt = torch.as_tensor(vol512).to(dev)
    dense_settings = {"committed": conv.BANDED_MIN_N, "dense": SENTINEL}
    d_ms = {k: [] for k in dense_settings}
    d_peak = {}
    outs = {}
    for k, n in dense_settings.items():
        with banded_min_n(n):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            outs[k] = fdense.extract_dense_descriptors(vt, RAW_UNITS, params)
            torch.cuda.synchronize()
            d_peak[k] = torch.cuda.max_memory_allocated(dev) - base
    forms_dev = (outs["committed"] - outs["dense"]).abs().max().item()
    del outs
    assert forms_dev <= DESC_TOL, forms_dev
    for _ in range(5):
        for k, n in dense_settings.items():
            with banded_min_n(n):
                o, ms = event_ms(lambda: fdense.extract_dense_descriptors(
                    vt, RAW_UNITS, params))
                del o
                d_ms[k].append(ms)
    del vt
    torch.cuda.empty_cache()
    n512 = vol512.shape[0]
    for k in dense_settings:
        blur = "framed" if n512 >= dense_settings[k] else "dense"
        print(f"dense {n512}^3 (config 3) {k} ({blur} blur): min of 5 "
              f"{min(d_ms[k]):.2f} ms by events, median "
              f"{np.median(d_ms[k]):.2f}, peak {d_peak[k] / 2**30:.2f} GiB "
              f"above its input [{card}]")
    print(f"dense {n512}^3 committed vs dense blur: max |dev| {forms_dev:.3e} "
          f"(tolerance {DESC_TOL})")
    return dict(rows=rows, composed=composed,
                pick=dict(banded_min_n=rule[0], frame_tile=rule[1]),
                detection=cmp_, register_framed=dict(ok=ok, A=res.A.tolist()),
                register_ms=reg_ms, pyramid=pyr_stage, dense_ms=d_ms,
                dense_peak_bytes=d_peak, dense_forms_dev=forms_dev)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    sys.path.insert(0, ROOT)
    from benches.data import SHIFT, make_pairs, make_volume, pair_ok
    from scripts.profile_register import profile_call
    from sift3d_tpu_torch import RegSift3D, SIFT3DParams, _build
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.config import MatchParams
    from sift3d_tpu_torch.features import detect as detect_mod
    from sift3d_tpu_torch.features.orientation import levels_args
    from sift3d_tpu_torch.ops import (cuda_extrema, cuda_match, cuda_orient,
                                      cuda_window)
    from sift3d_tpu_torch.ops.cuda_match import (reduce_one_way,
                                                 reduce_one_way_plain)
    from sift3d_tpu_torch.parallel.pipeline import (batch_detect_describe,
                                                    batch_register_pairs)
    from sift3d_tpu_torch.utils import trace

    dev = torch.device("cuda")
    card = card_line()
    CARD[0] = card
    print(card)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    detail: dict = {"card": card}

    # 1. Build.
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {', '.join(_build.sources())}")
    for name, out in _build.build_log.items():
        log(f"--- nvcc {name}.cu\n{out.strip()}")
    detail["build_s"] = build_s
    per_sm = cuda_window.blocks_per_sm()
    print(f"descrip_window: {per_sm} blocks an SM with its carveout set")
    assert per_sm == 4, per_sm

    reg = RegSift3D(device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    params = reg.sift.params

    src = make_volume((SIZE,) * 3, nblob=NBLOB, seed=SEED)
    ref = np.roll(src, SHIFT, axis=2)

    # 2. Kernels 1 and 3 against their plain versions on the real pyramid
    # levels of the 256^3 volume.
    s3d = reg.sift
    kp_src, d_src = s3d.detect_and_extract(src)
    plan = s3d._plan
    worst1 = check_descrip_window(
        level_args(s3d._gpyr, plan, kp_src, limit=N_CHECK_ROWS), "256^3")
    k1_args = level_args(s3d._gpyr, plan, kp_src)
    k3_args = []           # orient_levels' call of each volume's detection
    for vol in (src, ref):
        gpyr, ext = extrema_of(vol[None], plan, params, dev)
        k3_args.append(levels_args(detect_mod.keypoint_levels(gpyr, ext,
                                                              plan)))
    k3_check = check_orient(
        orient_args(*extrema_of(src[None], plan, params, dev), plan,
                    limit=N_CHECK_ROWS), params.corner_thresh, "256^3")
    k3_levels_check = check_orient_levels(k3_args[:1], params.corner_thresh,
                                          "256^3")
    kp_ref, d_ref = s3d.detect_and_extract(ref)
    k1_args += level_args(s3d._gpyr, plan, kp_ref)
    k4_sets = [extrema_sets(v[None], plan, params, dev) for v in (src, ref)]
    k4_check = check_extrema(k4_sets, params.peak_thresh, "256^3")

    # 3. Kernel 2 against its plain version (at the main path's arguments
    # and at multi-tile sizes) and against the dense matcher.
    detail["match_check"] = check_match_kernel(d_src, d_ref, dev)

    # 4. Main path: both matchers, counters read around each run.
    runs = {}
    for label, mp in (("default", MatchParams()),
                      ("streamed", MatchParams(impl="streamed"))):
        r = RegSift3D(match_params=mp, device=dev)
        trace.reset_counters()
        res = r.register(src, ref)
        torch.cuda.synchronize()
        counts = tuple(launches(k) for k in KERNELS_1_2_3)
        k4_launches = launches("extrema_scan")
        ok = bool(res.ok and pair_ok(res.A) and not res.kp_overflow)
        print(f"register {SIZE}^3 ({label} matcher): ok={ok}, "
              f"matches {len(res.match_src)}, inliers {res.num_inliers}, "
              f"launches descrip_window {counts[0]} match_stream "
              f"{counts[1]} orient_window {counts[2]} extrema_scan "
              f"{k4_launches}, A={np.round(res.A, 4).tolist()}")
        assert ok, f"{SIZE}^3 pair outside the contract ({label})"
        assert counts[0] > 0, "descrip_window never launched"
        assert counts[2] == 2, \
            f"orient_window launched {counts[2]} times, not once per detection"
        assert k4_launches == 6, \
            f"extrema_scan launched {k4_launches} times, not 3 a detection"
        runs[label] = dict(counts=counts, extrema_launches=k4_launches,
                           n_matches=len(res.match_src),
                           inliers=res.num_inliers, A=res.A.tolist())
    assert runs["streamed"]["counts"][1] > 0, "match_stream never launched"
    detail["runs"] = runs

    src4, ref4 = make_pairs(BATCH_PAIRS, BATCH_SHAPE)
    seq = []
    for s4, r4 in zip(src4[:CONFIG4_PAIRS], ref4[:CONFIG4_PAIRS]):
        res = reg.register(s4, r4)
        seq.append((bool(res.ok and pair_ok(res.A)), bool(res.ok), res.A))
    rate = float(np.mean([p for p, _, _ in seq]))
    print(f"config-4 pairs, one at a time: {sum(p for p, _, _ in seq)}/"
          f"{CONFIG4_PAIRS} pass the contract (rate {rate:.3f}, gate "
          f"{GATE_PASS_RATE})")
    assert rate >= GATE_PASS_RATE, rate
    detail["config4_pass_rate"] = rate

    # 5. The batched config-4 path: kernels 3 and 1 on one batched level
    # bucket, then batch_register_pairs with its launches counted.
    params4 = SIFT3DParams(**BATCH_CAPS)
    plan4 = pyr.plan_pyramid(BATCH_SHAPE[::-1], (1.0, 1.0, 1.0), params4)
    sides = []
    for vols in (src4, ref4):
        gpyr4, ext4 = extrema_of(vols, plan4, params4, dev)
        kp4, _, _ = batch_detect_describe(vols, plan4, params4, dev)
        sides.append((gpyr4, ext4, count_buckets(kp4, ext4)))
    gpyr4, ext4 = sides[0][:2]
    k3_batch_args = [levels_args(detect_mod.keypoint_levels(g, e, plan4))
                     for g, e, _ in sides]
    fullest = max(orient_args(gpyr4, ext4, plan4), key=lambda b: b[1][2])
    n_vols = int(fullest[1][8].unique().numel())
    k3_batch_check = check_orient([fullest], params4.corner_thresh,
                                  f"config-4 batch, {n_vols} volumes")
    k3_batch_levels_check = check_orient_levels(
        k3_batch_args[:1], params4.corner_thresh,
        f"config-4 batch, one side, {len(src4)} volumes")
    kp_flat, vol_flat = detect_mod.orient_levels(gpyr4, ext4, plan4, params4)
    k1_batch_args = []
    for g, e, _ in sides:
        k, v = detect_mod.orient_levels(g, e, plan4, params4)
        k1_batch_args += level_args(g, plan4, k, v)
    # Kernel 1 on the same level bucket, every step-th row (rows of many
    # volumes; the plain version is slow at the full bucket).
    bucket = [b for b in level_args(gpyr4, plan4, kp_flat, vol_flat)
              if b[0] == fullest[0]]
    step = max(1, bucket[0][1][3] // BATCH_CHECK_ROWS)
    fullest1 = [b for b in level_args(gpyr4, plan4, kp_flat, vol_flat,
                                      step=step) if b[0] == fullest[0]][0]
    n_vols1 = int(fullest1[1][9].unique().numel())
    worst1_batch = check_descrip_window([fullest1],
                                        f"config-4 batch, {n_vols1} volumes")
    k4_batch_sets = [extrema_sets(v, plan4, params4, dev)
                     for v in (src4, ref4)]
    k4_batch_check = check_extrema(k4_batch_sets, params4.peak_thresh,
                                   "config-4 batch, both sides")

    expect = [sum(side[2][i] for side in sides) for i in range(2)]
    trace.reset_counters()
    t0 = time.perf_counter()
    bres = batch_register_pairs(src4, ref4, plan4, params4, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batch_counts = tuple(launches(k) for k in KERNELS_1_2_3)
    batch_k4 = launches("extrema_scan")
    A4 = bres.A.cpu().numpy()
    ok4 = bres.ok.cpu().numpy()
    passed4 = ok4 & pair_ok(A4)
    rate4 = float(passed4.mean())
    n_over = int(bres.kp_overflow.sum())
    print(f"batch_register_pairs, {BATCH_PAIRS} config-4 pairs: "
          f"{int(passed4.sum())}/{BATCH_PAIRS} pass (rate {rate4:.3f}, gate "
          f"{GATE_PASS_RATE}), kp_overflow on {n_over} pairs; launches "
          f"orient_window {batch_counts[2]} (detections with rows "
          f"{expect[0]}), descrip_window {batch_counts[0]} (non-empty "
          f"{expect[1]}), match_stream {batch_counts[1]}, extrema_scan "
          f"{batch_k4}; first call {first_s:.2f} s")
    assert n_over == 0, "kp_overflow in the config-4 batch"
    assert rate4 >= GATE_PASS_RATE, rate4
    assert batch_counts[2] == expect[0], (batch_counts, expect)
    assert batch_counts[0] == expect[1], (batch_counts, expect)
    assert batch_k4 == 6, f"extrema_scan launched {batch_k4} times, not 3 a side"
    same_ok = sum(int(ok4[b]) == int(seq[b][1]) for b in range(CONFIG4_PAIRS))
    both = [b for b in range(CONFIG4_PAIRS) if ok4[b] and seq[b][1]]
    a_dev = max((np.abs(A4[b] - seq[b][2]).max() for b in both), default=0.0)
    print(f"batched vs one at a time, first {CONFIG4_PAIRS} pairs: ok equal "
          f"on {same_ok}, max |A dev| {a_dev:.3e} over {len(both)} pairs "
          f"ok on both")
    assert same_ok >= CONFIG4_PAIRS - 1, same_ok
    assert a_dev <= 1e-3, a_dev
    detail["batch"] = dict(pass_rate=rate4, counts=batch_counts,
                           extrema_launches=batch_k4, expected=expect,
                           same_ok=same_ok, a_dev=a_dev)

    # 6. Times (everything above was the warm-up).
    from sift3d_tpu_torch.ops.cuda_orient import (orient_terms_levels,
                                                  orient_terms_levels_plain,
                                                  orient_work_levels)
    from sift3d_tpu_torch.ops.cuda_window import (descrip_window,
                                                  descrip_window_plain,
                                                  descrip_work, slab_plan)

    def k1_times(args, reps):
        masks = {}      # launches on one tensor read its union once
        nb, ops, contrib, active, box = work_sum(
            lambda *a: descrip_work(*a, masks=masks), [a for _, a in args])
        b, by = bound_ms(nb, ops)
        return dict(
            launches=len(args), rows=sum(a[3] for _, a in args),
            blocks_per_launch=[a[3] * slab_plan(a[3], a[5][0])[1]
                               for _, a in args],
            active_voxels=active, box_voxels=box, active_share=active / box,
            contributing_voxels=contrib, contributing_share=contrib / box,
            ms=cuda_ms(lambda: [descrip_window(*a) for _, a in args], reps),
            plain_ms=cuda_ms(lambda: [descrip_window_plain(*a)
                                      for _, a in args], 1),
            bound_ms=b, bound_by=by, bytes=nb, ops=ops)
    k1_256 = k1_times(k1_args, 5)
    k1_batch = k1_times(k1_batch_args, 3)
    detail["descrip_window"] = dict(
        buckets=[dict(level=lv, rows=a[3], cores=a[5]) for lv, a in k1_args],
        reg_256=k1_256, batch=k1_batch)
    for label, t in (("256^3 registration", k1_256),
                     ("config-4 batch", k1_batch)):
        blk = t["blocks_per_launch"]
        print(f"descrip_window per {label} ({t['launches']} launches, "
              f"{t['rows']} rows, {min(blk)}-{max(blk)} blocks a launch, "
              f"voxels in the sphere and bin cube {t['active_share']:.4f} "
              f"of the boxes, adding to a bin "
              f"{t['contributing_share']:.4f}): "
              f"{t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) [{card}]")

    def k3_times(calls, reps):
        nb, o32, o64, active = work_sum(orient_work_levels, calls)
        b, by = bound_ms(nb, o32, o64)
        return dict(launches=len(calls),
                    rows=sum(c[0].shape[0] for c in calls),
                    levels=sum(int(a[1] > 0) for c in calls for a in c[1]),
                    active_voxels=active,
                    ms=cuda_ms(lambda: [orient_terms_levels(*c)
                                        for c in calls], reps),
                    alone_ms=kernel_alone_ms(
                        lambda: [orient_terms_levels(*c) for c in calls],
                        "orient_levels_kernel", reps),
                    plain_ms=cuda_ms(lambda: [orient_terms_levels_plain(*c)
                                              for c in calls], 1),
                    bound_ms=b, bound_by=by, bytes=nb, ops32=o32, ops64=o64)
    k3_256 = k3_times(k3_args, 5)
    k3_batch = k3_times(k3_batch_args, 5)
    detail["orient_window"] = dict(
        reg_256=k3_256, batch=k3_batch,
        checks=dict(buckets_256=k3_check, levels_256=k3_levels_check,
                    bucket_batch=k3_batch_check,
                    levels_batch=k3_batch_levels_check))
    for label, t in (("256^3 registration", k3_256),
                     ("config-4 batch", k3_batch)):
        print(f"orient_window per {label} ({t['launches']} launches, "
              f"{t['levels']} levels, {t['rows']} rows, "
              f"{t['active_voxels']} voxels counted): {t['ms']:.4f} ms by "
              f"events, kernel alone {fmt_ms(t['alone_ms'])}, plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}) [{card}]")

    from sift3d_tpu_torch.features.extrema import extrema_levels

    def k4_times(sets, rows, peak_thresh, reps):
        least, design, ops, passing, found = work_sum(
            lambda lv: cuda_extrema.scan_work(lv, peak_thresh),
            [(lv,) for lv in sets])
        b, by = bound_ms(least, ops)
        db, dby = bound_ms(design, ops)
        voxels = sum(lv[1].numel() for levels in sets for lv in levels)

        def passes():
            for levels, n in zip(sets, rows):
                cuda_extrema.scan(levels, peak_thresh)[2](n)
        return dict(
            calls=len(sets), rows=found, pass_share=passing / voxels,
            ms=cuda_ms(passes, reps),
            call_ms=cuda_ms(lambda: [extrema_levels(lv, peak_thresh)
                                     for lv in sets], reps),
            plain_ms=cuda_ms(lambda: [cuda_extrema.scan_plain(lv, peak_thresh)
                                      for lv in sets], 1),
            bound_ms=b, bound_by=by, bytes=least, design_bound_ms=db,
            design_bound_by=dby, design_bytes=design, ops=ops)
    k4_256 = k4_times(k4_sets, k4_check["rows"], params.peak_thresh, 5)
    k4_batch = k4_times(k4_batch_sets, k4_batch_check["rows"],
                        params4.peak_thresh, 5)
    detail["extrema_scan"] = dict(
        reg_256=k4_256, batch=k4_batch,
        checks=dict(reg_256=k4_check, batch=k4_batch_check))
    for label, t in (("256^3 registration", k4_256),
                     ("config-4 batch", k4_batch)):
        print(f"extrema_scan per {label} ({t['calls']} calls, {t['rows']} "
              f"rows, {t['pass_share']:.4f} of the voxels pass |c| > t): "
              f"{t['ms']:.4f} ms by events (passes), {t['call_ms']:.4f} ms "
              f"a call with its host read, plain {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, the least "
              f"bytes), the design's bytes {t['design_bound_ms']:.4f} ms "
              f"[{card}]")
    del k4_sets, k4_batch_sets

    def library(q, t, qs, ts):
        D = torch.clamp(qs[:, None] + ts[None, :] - 2.0 * (q @ t.T), min=0)
        return torch.topk(D, 2, dim=1, largest=False)

    def k2_times(args, reps):
        nq, nt = args[0].shape[0], args[1].shape[0]
        b, by = bound_ms((nq + nt) * 768 * 4 + (nq + nt) * 4 + nq * 12,
                         2.0 * nq * nt * 768)
        side, _, ranges = cuda_match.match_plan(nq, nt)
        return dict(nq=nq, nt=nt, tile=side, ranges=ranges,
                    blocks=-(-nq // side) * ranges,
                    ms=cuda_ms(lambda: reduce_one_way(*args), reps),
                    plain_ms=cuda_ms(lambda: reduce_one_way_plain(*args),
                                     reps),
                    library_ms=cuda_ms(lambda: library(*args), reps),
                    bound_ms=b, bound_by=by)
    k2_main = k2_times(main_path_args(d_src, d_ref)[0], 20)
    g = torch.Generator(device="cpu").manual_seed(1)
    big = [torch.rand((n, 768), generator=g).to(dev) for n in (2500, 2300)]
    big = [x / x.norm(dim=1, keepdim=True) for x in big]
    k2_big = k2_times((big[0], big[1], (big[0] ** 2).sum(1),
                       (big[1] ** 2).sum(1)), 5)
    detail["match_stream"] = dict(main=k2_main, multi_tile=k2_big)
    for label, t in ((f"the main path's {k2_main['nq']}x{k2_main['nt']}",
                      k2_main), ("2500x2300", k2_big)):
        print(f"match_stream at {label} (one direction, {t['tile']}-wide "
              f"tiles, {t['ranges']} target ranges, {t['blocks']} blocks): "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"matmul+topk {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}) [{card}]")

    def stage_line(prof):
        return ", ".join(f"{k} {v['host_ms']:.2f} / {v['device_busy_ms']:.2f}"
                         for k, v in prof["stages"].items()) + \
            (f"; total {prof['wall_ms']:.2f}, device busy "
             f"{prof['device_busy_ms']:.2f}, idle share "
             f"{prof['idle_share']:.3f}")

    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        reg.register(src, ref)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    _, prof = profile_call(lambda: reg.register(src, ref))
    detail["register_ms"] = calls
    detail["profile"] = prof
    print(f"stages ms ({SIZE}^3 pair, one profiled call, host span / device "
          f"busy): {stage_line(prof)}; unprofiled register min of 3 "
          f"{min(calls):.2f} [{card}]")

    bcalls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batch_register_pairs(src4, ref4, plan4, params4, device=dev)
        torch.cuda.synchronize()
        bcalls.append((time.perf_counter() - t0) * 1e3)
    _, bprof = profile_call(
        lambda: batch_register_pairs(src4, ref4, plan4, params4, device=dev))
    detail["batch_ms"] = bcalls
    detail["batch_profile"] = bprof
    print(f"batch_register_pairs ({BATCH_PAIRS} config-4 pairs): min of 5 "
          f"{min(bcalls):.2f} ms, {BATCH_PAIRS / min(bcalls) * 1e3:.2f} "
          f"pairs/s [{card}]")
    print(f"stages ms (config-4 batch, one profiled call, host span / device "
          f"busy): {stage_line(bprof)} [{card}]")

    # 7. The user surface on the default device (the card): the raw-image
    # paths, the resampled registration, the CLIs and the warp.
    from sift3d_tpu_torch import api
    from sift3d_tpu_torch.cli import kp as cli_kp
    from sift3d_tpu_torch.cli import reg as cli_reg
    from sift3d_tpu_torch.features.dense import smooth_scale_raw_input
    from sift3d_tpu_torch.features.descriptor import level_buckets
    from sift3d_tpu_torch.features.orientation import raw_keypoint_levels
    from sift3d_tpu_torch.io import Volume, im_read, im_write
    from sift3d_tpu_torch.io.csv import read_mat
    from sift3d_tpu_torch.ops.interp import im_inv_transform

    def counts():
        return launches("descrip_window"), launches("orient_window")

    def n_buckets(kp):
        return sum(1 for _ in level_buckets(kp, plan))

    # 7a. Raw-image paths on the SIZE^3 volume with its detection's rows.
    trace.reset_counters()
    R_raw, conf_raw = api.assign_orientations(src, kp_src, RAW_UNITS, params)
    torch.cuda.synchronize()
    raw_orient_counts = counts()
    assert raw_orient_counts == (0, 1), raw_orient_counts
    raw_sift = api.Sift3D(params)
    trace.reset_counters()
    d_raw = raw_sift.extract_raw(src, kp_src, RAW_UNITS)
    torch.cuda.synchronize()
    raw_desc_counts = counts()
    assert raw_desc_counts == (n_buckets(kp_src), 0), raw_desc_counts
    smoothed = smooth_scale_raw_input(torch.as_tensor(src).to(dev),
                                      RAW_UNITS, params)
    levels, _ = raw_keypoint_levels(smoothed, kp_src, plan, RAW_UNITS)
    raw_call = levels_args(levels)
    A_k, vd_k = cuda_orient.orient_terms_levels(*raw_call)
    keep, cut = first_rows(raw_call, RAW_CHECK_ROWS[0])
    want = cuda_orient.orient_terms_levels_plain(*cut)
    torch.cuda.synchronize()
    rel3, abs3, near3 = compare_terms((A_k[keep], vd_k[keep]), want,
                                      params.corner_thresh, f"raw {SIZE}^3")
    ext = [cuda_orient.table_extents(a[3], a[4]) for a in raw_call[1]]
    print(f"orient_window raw {SIZE}^3 vs plain: first {RAW_CHECK_ROWS[0]} rows "
          f"of each of {len(levels)} buckets ({int(keep.numel())} rows), max "
          f"rel dev {rel3:.3e} (tolerance {ORIENT_RTOL}), max abs dev "
          f"{abs3:.3e}; keypoint sets equal except {near3} near-threshold "
          f"rows; table extents up to {max(max(e) for e in ext)}")
    k1_raw_check = raw_k1_args(smoothed, plan, kp_src, params,
                               RAW_CHECK_ROWS[1])
    worst1_raw = check_descrip_window(k1_raw_check, f"raw {SIZE}^3")
    n = kp_src.count
    raw_pyr = (d_raw.vec[:n] - d_src.vec[:n]).abs().max().item()
    acc = torch.as_tensor(conf_raw[:n] >= 0)
    ang = angle_median(kp_src.R[:n][acc.to(dev)].cpu(),
                       torch.as_tensor(R_raw[:n])[acc])
    print(f"raw vs pyramid at {SIZE}^3 (not asserted): max |descriptor dev| "
          f"{raw_pyr:.4f} (rawDescriptorTest bound {RAW_DESC_BOUND}), median "
          f"angle between R {ang:.4f} rad over {int(acc.sum())} of {n} "
          f"accepted (rawOrientationTest bound {RAW_ANGLE_BOUND:.4f})")
    tables, boxes = [], 0
    for a in raw_call[1]:
        if not a[1]:
            continue
        if cuda_orient.box_walk(a[3], a[4]):
            boxes += 1
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tab = cuda_orient.offset_table(a[0].shape[-3:], *a[3:], dev)
        end.record()
        torch.cuda.synchronize()
        tables.append(dict(extents=cuda_orient.table_extents(a[3], a[4]),
                           entries=int(tab.shape[0]),
                           bytes=tab.numel() * tab.element_size(),
                           build_ms=start.elapsed_time(end)))
        del tab
    print(f"orient_window raw {SIZE}^3 tables: {len(tables)} levels, "
          f"{sum(t['bytes'] for t in tables)} bytes, largest "
          f"{max(t['entries'] for t in tables)} entries, built in "
          f"{sum(t['build_ms'] for t in tables):.2f} ms by events; {boxes} "
          f"levels walk their boxes [{card}]")
    detail["raw"] = dict(
        orient_counts=raw_orient_counts, desc_counts=raw_desc_counts,
        orient_check=dict(rows=int(keep.numel()), max_rel_err=rel3,
                          max_abs_err=abs3, near_threshold_rows=near3),
        desc_check=worst1_raw, raw_vs_pyramid_desc=raw_pyr,
        raw_vs_pyramid_angle=ang, tables=tables, box_walk_levels=boxes)

    # 7b. Resampled registration (regAnisoTest at size).
    aniso = np.ascontiguousarray(src[::2])
    trace.reset_counters()
    t0 = time.perf_counter()
    res = api.RegSift3D().register(Volume(src, (1.0, 1.0, 1.0)),
                                   Volume(aniso, (1.0, 1.0, 2.0)),
                                   resample=True)
    torch.cuda.synchronize()
    resample_s = time.perf_counter() - t0
    resample_counts = counts()
    lin = np.abs(res.A[:, :3] - np.diag([1.0, 1.0, 2.0])).max()
    trans = np.abs(res.A[:, 3]).max()
    print(f"register resample {SIZE}^3 / [::2] (units 1, 1, 2): ok={res.ok}, "
          f"matches {len(res.match_src)}, inliers {res.num_inliers}, |A - "
          f"diag(1, 1, 2)| {lin:.4f}, |t| {trans:.3f}, launches descrip_window "
          f"{resample_counts[0]} orient_window {resample_counts[1]}, "
          f"{resample_s:.3f} s, A={np.round(res.A, 4).tolist()}")
    assert res.ok and lin < 5e-2 and trans < 5.0, "resample outside contract"
    assert resample_counts[1] == 2 and resample_counts[0] > 0
    detail["resample"] = dict(A=res.A.tolist(), s=resample_s,
                              counts=resample_counts)

    # 7c. The CLIs on the card, on the SIZE^3 pair written as NIfTI.
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    cli_runs = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        def f(name):
            return os.path.join(tmp, name)
        im_write(f("src.nii"), Volume(src))
        im_write(f("ref.nii"), Volume(ref))
        trace.reset_counters()
        rc, t_kp = run_cli(cli_kp, ["--keys", f("keys.csv"), "--desc",
                                    f("desc.csv"), "--draw", f("draw.nii"),
                                    f("src.nii")], dev)
        kp_counts = counts()
        assert rc == 0, rc
        nk = check_csv(f("keys.csv"), 14)
        assert check_csv(f("desc.csv"), 771) == nk == kp_src.count
        assert im_read(f("draw.nii")).data.shape == src.shape
        assert kp_counts == (n_buckets(kp_src), 1), kp_counts
        trace.reset_counters()
        rc, t_reg = run_cli(cli_reg, [
            "--matches", f("m.csv"), "--transform", f("t.csv"), "--warped",
            f("w.nii"), "--concat", f("c.nii"), "--keys", f("k.nii"),
            "--lines", f("l.nii"), f("src.nii"), f("ref.nii")], dev)
        reg_counts = counts()
        assert rc == 0, rc
        nm = check_csv(f("m.csv"), 6)
        assert check_csv(f("t.csv"), 4) == 3
        A_cli = read_mat(f("t.csv"))
        assert pair_ok(A_cli), f"CLI transform outside the contract: {A_cli}"
        assert im_read(f("w.nii")).data.shape == ref.shape
        assert reg_counts == (n_buckets(kp_src) + n_buckets(kp_ref), 2), \
            reg_counts
    for name, t, c in (("kpSift3D", t_kp, kp_counts),
                       ("regSift3D", t_reg, reg_counts)):
        print(f"{name} on the {SIZE}^3 {'image' if c[1] == 1 else 'pair'}: wall "
              f"{t['wall']:.3f} s = read {t['read']:.3f} + compute "
              f"{t['compute']:.3f} + write {t['write']:.3f}; launches "
              f"descrip_window {c[0]} orient_window {c[1]} [{card}]")
    print(f"regSift3D CLI: {nm} matches, A={np.round(A_cli, 4).tolist()}")
    cli_runs = dict(kp=dict(t_kp, counts=kp_counts, keys=nk),
                    reg=dict(t_reg, counts=reg_counts, matches=nm,
                             A=A_cli.tolist()))
    detail["cli"] = cli_runs

    # 7d. Warp and raw-call times.
    A_main = np.asarray(runs["default"]["A"])
    src_d = torch.as_tensor(src).to(dev)
    warp_ms = {}
    for interp in ("linear", "lanczos2"):
        warp_ms[interp] = dict(
            api_ms=min(cuda_ms(lambda: api.warp(src, A_main, interp=interp),
                               1) for _ in range(3)),
            device_ms=min(cuda_ms(lambda: im_inv_transform(
                A_main, src_d, None, interp), 1) for _ in range(3)))
        print(f"warp {SIZE}^3 {interp}: {warp_ms[interp]['api_ms']:.3f} ms "
              f"(api.warp, numpy in and out), "
              f"{warp_ms[interp]['device_ms']:.3f} ms (im_inv_transform on "
              f"the card), min of 3 by events [{card}]")
    detail["warp_ms"] = warp_ms
    k3_raw = k3_times([raw_call], 3)
    k3_raw["rows_entries_max"] = max(t["entries"] for t in tables)
    k1_raw_args = raw_k1_args(smoothed, plan, kp_src, params)
    k1_raw = k1_times(k1_raw_args, 3)
    k1_raw["alone_ms"] = kernel_alone_ms(
        lambda: [descrip_window(*a) for _, a in k1_raw_args],
        ("descrip_window_kernel", "tile_range_kernel", "merge_slabs_kernel"),
        3)
    detail["raw"].update(orient_times=k3_raw, desc_times=k1_raw)
    print(f"orient_window raw {SIZE}^3 ({k3_raw['launches']} launch, "
          f"{k3_raw['levels']} levels, {k3_raw['rows']} rows, "
          f"{k3_raw['active_voxels']} voxels counted, largest table "
          f"{k3_raw['rows_entries_max']} entries): {k3_raw['ms']:.3f} ms by "
          f"events (tables included), kernel alone "
          f"{fmt_ms(k3_raw['alone_ms'], 3)}, plain "
          f"{k3_raw['plain_ms']:.1f} ms, bound {k3_raw['bound_ms']:.5f} ms "
          f"({k3_raw['bound_by']}) [{card}]")
    print(f"descrip_window raw {SIZE}^3 ({k1_raw['launches']} launches, "
          f"{k1_raw['rows']} rows, {min(k1_raw['blocks_per_launch'])}-"
          f"{max(k1_raw['blocks_per_launch'])} blocks a launch): "
          f"{k1_raw['ms']:.3f} ms by events, kernel alone "
          f"{fmt_ms(k1_raw['alone_ms'], 3)}, plain "
          f"{k1_raw['plain_ms']:.1f} ms, bound {k1_raw['bound_ms']:.4f} ms "
          f"({k1_raw['bound_by']}) [{card}]")

    # 8. The sixth slice: kernels 3 and 1 past their old size limits (F1),
    # dense descriptors (config 3 at 512^3, the rotate variant), TPS
    # registration and the dense CLI.
    f1 = check_f1(dev, params.corner_thresh)
    dense, vol512 = dense_phase(src, dev)
    rot = rotate_phase(dev, params.corner_thresh)
    tps = tps_phase(src, ref, dev)
    detail.update(f1=f1, dense=dense, rotate=rot, tps=tps)

    # 9. The seventh slice: groupwise registration of the config-5 fleet,
    # from the source volume of the first config-4 pair that phase 4
    # registered within the contract (pair 0 unless it failed).
    fleet_pair = next(b for b, (passed, _, _) in enumerate(seq) if passed)
    print(f"fleet base: config-4 pair {fleet_pair}'s source volume")
    t0 = time.perf_counter()
    fleet, fleet_state = fleet_phase(src4[fleet_pair], dev, plan4, params4,
                                     k1_times, k3_times)
    fleet_s = time.perf_counter() - t0
    print(f"phase 9: {fleet_s:.1f} s")
    detail.update(fleet=dict(fleet, base_pair=fleet_pair, phase_s=fleet_s))

    # 10. The eighth slice: the multi-GPU paths at world size 1 (NCCL).
    t0 = time.perf_counter()
    mesh10 = mesh_phase(dev, src, plan, params, kp_src, d_src, d_ref, big,
                        (src4, ref4, plan4, params4),
                        (bres, batch_counts, min(bcalls)), fleet_state)
    mesh_s = time.perf_counter() - t0
    print(f"phase 10: {mesh_s:.1f} s")
    detail.update(mesh=dict(mesh10, phase_s=mesh_s))

    # The kernels line: every number it holds is in by now (phases 11 and
    # 12 add none).
    by_path = {
        "descrip_window": dict(register_256=runs["default"]["counts"][0],
                               batch_config4=batch_counts[0],
                               extract_raw_256=raw_desc_counts[0],
                               register_resample_256=resample_counts[0],
                               cli_kp_256=kp_counts[0],
                               cli_reg_256=reg_counts[0]),
        "match_stream": dict(register_256_streamed=runs["streamed"]["counts"][1],
                             batch_config4=batch_counts[1]),
        "orient_window": dict(register_256=runs["default"]["counts"][2],
                              batch_config4=batch_counts[2],
                              assign_orientations_256=raw_orient_counts[1],
                              register_resample_256=resample_counts[1],
                              cli_kp_256=kp_counts[1],
                              cli_reg_256=reg_counts[1]),
    }
    for name, i in (("descrip_window", 0), ("orient_window", 1)):
        by_path[name].update(
            dense_512=dense["counts"][i], dense_rotate_128=rot["counts"][i],
            register_tps_256=tps["counts"][i],
            cli_reg_tps_256=tps["cli_counts"][i],
            cli_dense_256=dense["cli"]["counts"][i],
            groupwise_fleet_256=fleet["counts"][i])
    by_path["match_stream"]["groupwise_fleet_256"] = 0
    by_path["extrema_scan"] = dict(
        register_256=runs["default"]["extrema_launches"],
        register_256_streamed=runs["streamed"]["extrema_launches"],
        batch_config4=batch_k4)
    for name, i in (("descrip_window", 0), ("match_stream", 1),
                    ("orient_window", 2)):
        by_path[name]["batch_config4_mesh"] = mesh10["c"]["counts"][i]
    by_path["match_stream"].update({
        f"nn_match_sharded_{k.replace(' ', '_')}": v["launches"]
        for k, v in mesh10["b"].items() if isinstance(v, dict)})
    per_reg = "all launches of one 256^3 registration"
    k3_checks = (k3_check, k3_levels_check, k3_batch_check,
                 k3_batch_levels_check)
    kernels = [
        dict(name="descrip_window", route="cuda",
             source="sift3d_tpu_torch/csrc/descrip_window.cu",
             replaces="sift3d_tpu/ops/pallas_window.py:49",
             launches=batch_counts[0], max_abs_err=max(worst1, worst1_batch),
             ms=k1_256["ms"], plain_ms=k1_256["plain_ms"],
             bound_ms=k1_256["bound_ms"], bound_by=k1_256["bound_by"],
             library_ms=None, ms_for=per_reg,
             launches_by_path=by_path["descrip_window"],
             raw_ms=k1_raw["ms"], raw_alone_ms=k1_raw["alone_ms"],
             raw_plain_ms=k1_raw["plain_ms"], raw_bound_ms=k1_raw["bound_ms"],
             raw_bound_by=k1_raw["bound_by"], raw_max_abs_err=worst1_raw,
             batch_ms=k1_batch["ms"], batch_plain_ms=k1_batch["plain_ms"],
             batch_bound_ms=k1_batch["bound_ms"],
             batch_bound_by=k1_batch["bound_by"],
             blocks_per_launch_256=k1_256["blocks_per_launch"],
             blocks_per_launch_batch=k1_batch["blocks_per_launch"],
             active_share_256=k1_256["active_share"],
             active_share_batch=k1_batch["active_share"],
             contributing_share_256=k1_256["contributing_share"],
             contributing_share_batch=k1_batch["contributing_share"],
             f1_shape=f1["k1"]["shape"], f1_cores=f1["k1"]["cores"],
             f1_ms=f1["k1"]["ms"], f1_plain_ms=f1["k1"]["plain_ms"],
             f1_bound_ms=f1["k1"]["bound_ms"],
             f1_bound_by=f1["k1"]["bound_by"],
             f1_max_abs_err=f1["k1"]["max_abs_err"],
             fleet_ms=fleet["k1"]["ms"],
             fleet_plain_ms=fleet["k1"]["plain_ms"],
             fleet_bound_ms=fleet["k1"]["bound_ms"],
             fleet_bound_by=fleet["k1"]["bound_by"],
             fleet_max_abs_err=fleet["k1"]["max_abs_err"]),
        dict(name="match_stream", route="cuda",
             source="sift3d_tpu_torch/csrc/match_stream.cu",
             replaces="sift3d_tpu/ops/pallas_match.py:63",
             launches=runs["streamed"]["counts"][1],
             max_abs_err=detail["match_check"]["max_abs_err"],
             ms=k2_main["ms"], plain_ms=k2_main["plain_ms"],
             bound_ms=k2_main["bound_ms"], bound_by=k2_main["bound_by"],
             library_ms=k2_main["library_ms"],
             ms_for="one launch (one direction) at the 256^3 pair's shapes",
             launches_by_path=by_path["match_stream"],
             ranges=k2_main["ranges"], tile=k2_main["tile"],
             multi_tile_shape=[k2_big["nq"], k2_big["nt"]],
             multi_tile_ms=k2_big["ms"],
             multi_tile_plain_ms=k2_big["plain_ms"],
             multi_tile_library_ms=k2_big["library_ms"],
             multi_tile_bound_ms=k2_big["bound_ms"],
             multi_tile_ranges=k2_big["ranges"],
             multi_tile_tile=k2_big["tile"],
             sharded_launches_per_call=mesh10["b"]["2500x2300"]["launches"],
             sharded_2500x2300_call_ms=mesh10["b"]["sharded_ms"],
             streamed_2500x2300_call_ms=mesh10["b"]["streamed_ms"],
             sharded_2500x2300_kernel_alone_ms=mesh10["b"][
                 "sharded_kernel_ms"],
             streamed_2500x2300_kernel_alone_ms=mesh10["b"][
                 "streamed_kernel_ms"]),
        dict(name="orient_window", route="cuda",
             source="sift3d_tpu_torch/csrc/orient_window.cu",
             replaces="sift3d_tpu/ops/pallas_orient.py:38",
             launches=batch_counts[2],
             max_abs_err=max(c["max_abs_err"] for c in k3_checks),
             max_rel_err=max(c["max_rel_err"] for c in k3_checks),
             ms=k3_256["ms"], plain_ms=k3_256["plain_ms"],
             bound_ms=k3_256["bound_ms"], bound_by=k3_256["bound_by"],
             library_ms=None, ms_for=per_reg,
             launches_by_path=by_path["orient_window"],
             raw_ms=k3_raw["ms"], raw_alone_ms=k3_raw["alone_ms"],
             raw_plain_ms=k3_raw["plain_ms"], raw_bound_ms=k3_raw["bound_ms"],
             raw_bound_by=k3_raw["bound_by"], raw_max_rel_err=rel3,
             raw_table_bytes=sum(t["bytes"] for t in tables),
             raw_table_build_ms=sum(t["build_ms"] for t in tables),
             batch_ms=k3_batch["ms"], batch_plain_ms=k3_batch["plain_ms"],
             batch_bound_ms=k3_batch["bound_ms"],
             batch_bound_by=k3_batch["bound_by"],
             alone_ms=k3_256["alone_ms"], batch_alone_ms=k3_batch["alone_ms"],
             levels_256=k3_256["levels"], levels_batch=k3_batch["levels"],
             f1_shape=f1["k3"]["shape"], f1_extents=f1["k3"]["extents"],
             f1_ms=f1["k3"]["ms"], f1_plain_ms=f1["k3"]["plain_ms"],
             f1_bound_ms=f1["k3"]["bound_ms"],
             f1_bound_by=f1["k3"]["bound_by"],
             f1_max_rel_err=f1["k3"]["max_rel_err"],
             raw_box_walk_levels=boxes,
             rotate_rows=rot["rows"], rotate_ms=rot["k3"]["ms"],
             rotate_plain_ms=rot["k3"]["plain_ms"],
             rotate_bound_ms=rot["k3"]["bound_ms"],
             rotate_bound_by=rot["k3"]["bound_by"],
             rotate_max_rel_err=rot["k3"]["max_rel_err"],
             fleet_ms=fleet["k3"]["ms"],
             fleet_alone_ms=fleet["k3"]["alone_ms"],
             fleet_plain_ms=fleet["k3"]["plain_ms"],
             fleet_bound_ms=fleet["k3"]["bound_ms"],
             fleet_bound_by=fleet["k3"]["bound_by"],
             fleet_max_rel_err=fleet["k3"]["check"]["max_rel_err"]),
        dict(name="extrema_scan", route="cuda",
             source="sift3d_tpu_torch/csrc/extrema_scan.cu",
             replaces=None, launches=batch_k4, max_abs_err=0,
             ms=k4_256["ms"], plain_ms=k4_256["plain_ms"],
             bound_ms=k4_256["bound_ms"], bound_by=k4_256["bound_by"],
             library_ms=None,
             ms_for="both detections of one 256^3 registration, the passes "
                    "without the host read",
             launches_by_path=by_path["extrema_scan"],
             call_ms=k4_256["call_ms"],
             design_bound_ms=k4_256["design_bound_ms"],
             pass_share=k4_256["pass_share"], rows=k4_256["rows"],
             batch_ms=k4_batch["ms"], batch_call_ms=k4_batch["call_ms"],
             batch_plain_ms=k4_batch["plain_ms"],
             batch_bound_ms=k4_batch["bound_ms"],
             batch_bound_by=k4_batch["bound_by"],
             batch_design_bound_ms=k4_batch["design_bound_ms"],
             batch_pass_share=k4_batch["pass_share"],
             batch_rows=k4_batch["rows"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))

    # 11. This slice: the convolution's form set by measurement, and the
    # paths it reaches with the form forced.
    t0 = time.perf_counter()
    banded = banded_phase(dev, src, ref, plan, params, vol512)
    del vol512
    banded_s = time.perf_counter() - t0
    print(f"phase 11: {banded_s:.1f} s")
    detail.update(banded=dict(banded, phase_s=banded_s))

    # 12. This slice: the examples, run as a user runs them.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples = examples_phase(src, ref, dev)
    examples_s = time.perf_counter() - t0
    print(f"phase 12: {examples_s:.1f} s")
    detail.update(examples=dict(examples, phase_s=examples_s))

    log("detail: " + json.dumps(detail))

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
