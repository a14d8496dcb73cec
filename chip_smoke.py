"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift3d_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source, into ``build/kernels/``), then:

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
   score lies within 1e-5 of its threshold, which are counted;
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
   exactly once per detection: 2); both
   affines must meet the reference's 5e-2 / 5-voxel contract; then
   registers the first 16 config-4 pairs (64^3) one at a time and asserts
   a pass rate >= 0.60;
5. checks kernels 3 and 1 on one level bucket of the config-4 batch, with
   the rows of many volumes in one launch (1e-5 and 2e-3 as above), and
   kernel 3 on every level of one side of the batch in one launch, then
   drives the batched path, ``parallel.pipeline.batch_register_pairs``, on
   64 config-4 pairs at ``bench.py``'s caps, counters set to 0 just before
   and read just after: kernel 3 launches once per side (one detection of
   all levels and volumes), kernel 1 once per non-empty level bucket of
   each side (not once per volume), no pair reports
   ``kp_overflow``, the pass rate is >= 0.60, and the first 16 pairs agree
   with the sequential results of phase 4 (``ok`` on >= 15, A within 1e-3
   where both are ok);
6. times each kernel, its plain version and a library yardstick (kernel 3
   as ``orient_levels`` calls it, by CUDA events and alone in the
   profiler's trace), the
   batched call (min of 5, pairs/s), and profiles one 256^3 registration
   and one batched call: each stage's ``sift3d.<stage>`` span on the host
   and the device, the device's busy time and idle share
   (``scripts/profile_register.profile_call``). Kernel 1 is reported with
   its blocks per launch (``slab_plan``) and the share of box voxels that
   pass its geometry tests; kernel 2 at the
   main path's shape and at 2500 x 2300, with its tile side and target
   ranges (``match_plan``).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when no CUDA device is present or any check fails. Per-stage and
per-bucket details go to standard error as one JSON line.
"""

from __future__ import annotations

import gzip
import json
import os
import re
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
FP64_OPS_PER_S = 34e12     # H100 SXM fp64 outside the tensor cores
RAW_UNITS = (1.0, 1.0, 1.0)
RAW_CHECK_ROWS = (3, 4)    # rows of each bucket checked: kernels 3 and 1
RAW_DESC_BOUND = 0.2       # rawDescriptorTest (Sift3DTest.m:179-201)
RAW_ANGLE_BOUND = np.pi / 8  # rawOrientationTest (Sift3DTest.m:205-242)
CSV_FIELD = re.compile(r"-?\d+\.\d{6}")


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S + ops64 / FP64_OPS_PER_S) * 1e3
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


def compare_terms(got, want, corner_thresh, where) -> tuple[float, float,
                                                            int]:
    """Kernel 3's sums ``got`` against the plain version's ``want`` (rows
    below count): within ORIENT_RTOL of each row's largest |term|, and the
    keypoint sets that follow equal except on near-threshold rows. Returns
    (max relative deviation, max abs deviation, rows that differ)."""
    from sift3d_tpu_torch.features.orientation import (
        orientation_scores, orientations_from_tensor)
    (A_k, vd_k), (A_p, vd_p) = got, want
    assert A_k.dtype == torch.float64, "kernel 3 sums must be float64"
    if not A_p.shape[0]:
        return 0.0, 0.0, 0
    scale = torch.maximum(A_p.abs().amax(1), vd_p.abs().amax(1).double())
    dev_ = torch.maximum((A_k - A_p).abs().amax(1),
                         (vd_k - vd_p).abs().amax(1).double())
    rel = (dev_ / scale.clamp(min=1e-300)).max().item()
    assert rel <= ORIENT_RTOL, f"{where}: kernel 3 rel dev {rel:.3e}"
    R_k, ok_k = orientations_from_tensor(A_k, vd_k, corner_thresh)
    R_p, ok_p = orientations_from_tensor(A_p, vd_p, corner_thresh)
    _, _, ratio, corner = orientation_scores(A_p, vd_p)
    near_rows = ((ratio - 0.90).abs() <= NEAR_THRESH).any(-1) | \
        ((corner - corner_thresh).abs() <= NEAR_THRESH)
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
        before = orient_terms_levels.launches
        A_k, vd_k = orient_terms_levels(rows_p, args_p)
        assert orient_terms_levels.launches == before + 1
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
    from sift3d_tpu_torch.features.match import nn_match, ssd_matrix
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
    diff = m_stream != m_dense
    if diff.any():
        D = ssd_matrix(d1, d2)
        D = torch.where(v1[:, None] & v2[None, :], D, inf)
        fv = torch.topk(D, 2, dim=1, largest=False).values
        bv = torch.topk(D.T, 2, dim=1, largest=False).values
        fr = _fragile(fv[:, 0], fv[:, 1], T2)
        br = _fragile(bv[:, 0], bv[:, 1], T2)
        j = torch.argmin(D, dim=1)
        js = m_stream.clamp(min=0).long()
        ok = fr | br[j] | br[js]
        assert not (diff & ~ok).any(), \
            f"streamed vs dense: {int((diff & ~ok).sum())} rows differ"
        n_fragile += int(diff.sum())
    n_matched = int((m_dense >= 0).sum())
    print(f"match_stream vs plain at the main path's {main_shape[0]}x"
          f"{main_shape[1]} and vs plain and dense at {n1}x{n2}: indices "
          f"exact, {n_fragile} near-tie rows differ, {n_matched} matches, "
          f"max |best SSD dev| {max_err:.3e}")
    return dict(main_shape=main_shape, n1=n1, n2=n2,
                near_tie_rows=n_fragile, matches=n_matched,
                max_abs_err=max_err)


def count_buckets(kp, ext) -> tuple[int, int]:
    """The launches kernels 3 and 1 should make for one side of a batch:
    one for the detection if any level has extrema rows, and one per
    level bucket of kept keypoints."""
    n_orient = int(any(rows.shape[0] > 0 for rows, _, _ in ext.values()))
    valid = kp.valid_mask()
    n_desc = len({(int(o), int(s)) for o, s in
                  zip(kp.o[valid].tolist(), kp.s[valid].tolist())})
    return n_orient, n_desc


def kernel_alone_ms(fn, name, reps: int) -> float:
    """Device time of the kernels whose name holds ``name`` (or one of a
    tuple of names), per call of ``fn``, from the profiler's trace of
    ``reps`` calls."""
    names = (name,) if isinstance(name, str) else tuple(name)
    import tempfile
    fn()
    torch.cuda.synchronize()
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
    us = [e["dur"] for e in events if e.get("ph") == "X" and
          e.get("cat") == "kernel" and
          any(n in e.get("name", "") for n in names)]
    assert us, f"no {name} kernel in the profile"
    return sum(us) / 1e3 / reps


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


def angle_median(R1, R2) -> float:
    tr = torch.einsum("kij,kij->k", R1.double(), R2.double())
    return float(torch.median(torch.arccos(((tr - 1) / 2).clamp(-1, 1))))


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
    from sift3d_tpu_torch.ops import cuda_match, cuda_orient, cuda_window
    from sift3d_tpu_torch.ops.cuda_match import (reduce_one_way,
                                                 reduce_one_way_plain)
    from sift3d_tpu_torch.parallel.pipeline import (batch_detect_describe,
                                                    batch_register_pairs)

    dev = torch.device("cuda")
    card = card_line()
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

    # 3. Kernel 2 against its plain version (at the main path's arguments
    # and at multi-tile sizes) and against the dense matcher.
    detail["match_check"] = check_match_kernel(d_src, d_ref, dev)

    # 4. Main path: both matchers, counters read around each run.
    runs = {}
    for label, mp in (("default", MatchParams()),
                      ("streamed", MatchParams(impl="streamed"))):
        r = RegSift3D(match_params=mp, device=dev)
        cuda_window.descrip_window.launches = 0
        cuda_match.reduce_one_way.launches = 0
        cuda_orient.orient_terms_levels.launches = 0
        res = r.register(src, ref)
        torch.cuda.synchronize()
        counts = (cuda_window.descrip_window.launches,
                  cuda_match.reduce_one_way.launches,
                  cuda_orient.orient_terms_levels.launches)
        ok = bool(res.ok and pair_ok(res.A) and not res.kp_overflow)
        print(f"register {SIZE}^3 ({label} matcher): ok={ok}, "
              f"matches {len(res.match_src)}, inliers {res.num_inliers}, "
              f"launches descrip_window {counts[0]} match_stream "
              f"{counts[1]} orient_window {counts[2]}, "
              f"A={np.round(res.A, 4).tolist()}")
        assert ok, f"{SIZE}^3 pair outside the contract ({label})"
        assert counts[0] > 0, "descrip_window never launched"
        assert counts[2] == 2, \
            f"orient_window launched {counts[2]} times, not once per detection"
        runs[label] = dict(counts=counts, n_matches=len(res.match_src),
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

    expect = [sum(side[2][i] for side in sides) for i in range(2)]
    cuda_window.descrip_window.launches = 0
    cuda_orient.orient_terms_levels.launches = 0
    cuda_match.reduce_one_way.launches = 0
    t0 = time.perf_counter()
    bres = batch_register_pairs(src4, ref4, plan4, params4, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batch_counts = (cuda_window.descrip_window.launches,
                    cuda_match.reduce_one_way.launches,
                    cuda_orient.orient_terms_levels.launches)
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
          f"{expect[1]}), match_stream {batch_counts[1]}; first call "
          f"{first_s:.2f} s")
    assert n_over == 0, "kp_overflow in the config-4 batch"
    assert rate4 >= GATE_PASS_RATE, rate4
    assert batch_counts[2] == expect[0], (batch_counts, expect)
    assert batch_counts[0] == expect[1], (batch_counts, expect)
    same_ok = sum(int(ok4[b]) == int(seq[b][1]) for b in range(CONFIG4_PAIRS))
    both = [b for b in range(CONFIG4_PAIRS) if ok4[b] and seq[b][1]]
    a_dev = max((np.abs(A4[b] - seq[b][2]).max() for b in both), default=0.0)
    print(f"batched vs one at a time, first {CONFIG4_PAIRS} pairs: ok equal "
          f"on {same_ok}, max |A dev| {a_dev:.3e} over {len(both)} pairs "
          f"ok on both")
    assert same_ok >= CONFIG4_PAIRS - 1, same_ok
    assert a_dev <= 1e-3, a_dev
    detail["batch"] = dict(pass_rate=rate4, counts=batch_counts,
                           expected=expect, same_ok=same_ok, a_dev=a_dev)

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
              f"events, kernel alone {t['alone_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}) [{card}]")

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
        return (cuda_window.descrip_window.launches,
                cuda_orient.orient_terms_levels.launches)

    def zero_counts():
        cuda_window.descrip_window.launches = 0
        cuda_orient.orient_terms_levels.launches = 0

    def n_buckets(kp):
        return sum(1 for _ in level_buckets(kp, plan))

    # 7a. Raw-image paths on the SIZE^3 volume with its detection's rows.
    zero_counts()
    R_raw, conf_raw = api.assign_orientations(src, kp_src, RAW_UNITS, params)
    torch.cuda.synchronize()
    raw_orient_counts = counts()
    assert raw_orient_counts == (0, 1), raw_orient_counts
    raw_sift = api.Sift3D(params)
    zero_counts()
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
    tables = []
    for a in raw_call[1]:
        if not a[1]:
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
          f"{sum(t['build_ms'] for t in tables):.2f} ms by events [{card}]")
    detail["raw"] = dict(
        orient_counts=raw_orient_counts, desc_counts=raw_desc_counts,
        orient_check=dict(rows=int(keep.numel()), max_rel_err=rel3,
                          max_abs_err=abs3, near_threshold_rows=near3),
        desc_check=worst1_raw, raw_vs_pyramid_desc=raw_pyr,
        raw_vs_pyramid_angle=ang, tables=tables)

    # 7b. Resampled registration (regAnisoTest at size).
    aniso = np.ascontiguousarray(src[::2])
    zero_counts()
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
        zero_counts()
        rc, t_kp = run_cli(cli_kp, ["--keys", f("keys.csv"), "--desc",
                                    f("desc.csv"), "--draw", f("draw.nii"),
                                    f("src.nii")], dev)
        kp_counts = counts()
        assert rc == 0, rc
        nk = check_csv(f("keys.csv"), 14)
        assert check_csv(f("desc.csv"), 771) == nk == kp_src.count
        assert im_read(f("draw.nii")).data.shape == src.shape
        assert kp_counts == (n_buckets(kp_src), 1), kp_counts
        zero_counts()
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
          f"events (tables included), kernel alone {k3_raw['alone_ms']:.3f} "
          f"ms, plain {k3_raw['plain_ms']:.1f} ms, bound "
          f"{k3_raw['bound_ms']:.5f} ms ({k3_raw['bound_by']}) [{card}]")
    print(f"descrip_window raw {SIZE}^3 ({k1_raw['launches']} launches, "
          f"{k1_raw['rows']} rows, {min(k1_raw['blocks_per_launch'])}-"
          f"{max(k1_raw['blocks_per_launch'])} blocks a launch): "
          f"{k1_raw['ms']:.3f} ms by events, kernel alone "
          f"{k1_raw['alone_ms']:.3f} ms, plain {k1_raw['plain_ms']:.1f} ms, "
          f"bound {k1_raw['bound_ms']:.4f} ms ({k1_raw['bound_by']}) [{card}]")

    log("detail: " + json.dumps(detail))

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
             contributing_share_batch=k1_batch["contributing_share"]),
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
             multi_tile_tile=k2_big["tile"]),
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
             levels_256=k3_256["levels"], levels_batch=k3_batch["levels"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
