"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift3d_tpu_torch/csrc`` (nvcc,
sm_90a, into ``build/kernels/``), then:

1. holds the descriptor-window kernel against its plain PyTorch version on
   the real pyramid levels of a 256^3 volume (max abs deviation <= 2e-3 on
   the postprocessed descriptors, rows past ``count`` zero);
2. holds the streamed-matcher kernel against its plain version, at the
   main path's arguments and at multi-tile sizes with invalid and
   duplicated rows, and against the dense matcher (best and second SSD
   within fp32 rounding, indices exact; a row may differ only where the
   plain version's two SSDs agree to fp32 rounding, and such rows are
   counted);
3. drives the main path, ``RegSift3D().register(src, ref)``, on the 256^3
   volume and its copy rolled by ``SHIFT`` voxels along x, once with the
   default matcher and once with ``MatchParams(impl="streamed")``, with the
   kernels' launch counters set to 0 just before each run and read just
   after; both affines must meet the reference's 5e-2 / 5-voxel contract;
   then registers the first 16 config-4 pairs (64^3) and asserts a pass
   rate >= 0.60;
4. times each kernel, its plain version and a library yardstick, and
   profiles one 256^3 registration: each stage's ``sift3d.<stage>`` span
   on the host and the device, the device's busy time and idle share
   (``scripts/profile_register.profile_call``).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when no CUDA device is present or any check fails. Per-stage and
per-bucket details go to standard error as one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores


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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_args(s3d, kp, limit=None):
    """Kernel-1 arguments of every non-empty level bucket of ``kp``."""
    from sift3d_tpu_torch.features.descriptor import (level_buckets,
                                                      level_geometry)
    out = []
    for (o, s), rows in level_buckets(kp, s3d._plan):
        rows = rows[:limit]
        level = s3d._gpyr[(o, s)]
        units = s3d._plan.octave_units(o)
        sigma, rad, radii, cores = level_geometry(
            s3d._plan.gpyr_level(o, s).scale, units, level.shape)
        centers = torch.stack([kp.z[rows], kp.y[rows], kp.x[rows]], -1).float()
        out.append(((o, s), (level, centers, kp.R[rows], len(rows), radii,
                             cores, units, sigma, rad)))
    return out


def check_descrip_window(s3d, kp) -> float:
    from sift3d_tpu_torch.features.descriptor import postprocess
    from sift3d_tpu_torch.ops.cuda_window import (descrip_window,
                                                  descrip_window_plain)
    worst = 0.0
    buckets = level_args(s3d, kp, N_CHECK_ROWS)
    assert buckets, "no keypoints on the 256^3 volume"
    for lv, args in buckets:
        level, centers, R, n = args[:4]
        pad = 5   # rows past count: the kernel must write zeros there
        centers_p = torch.cat([centers, centers[:1].expand(pad, 3)])
        R_p = torch.cat([R, R[:1].expand(pad, 3, 3)])
        got = descrip_window(level, centers_p, R_p, n, *args[4:])
        want = descrip_window_plain(level, centers, R, n, *args[4:])
        torch.cuda.synchronize()
        assert torch.all(got[n:] == 0), f"rows past count not zero at {lv}"
        dev = (postprocess(got[:n]) - postprocess(want)).abs().max().item()
        log(f"kernel 1 level {lv}: {n} rows, cores {args[5]}, "
            f"max |dev| {dev:.3e}")
        worst = max(worst, dev)
    print(f"descrip_window vs plain: max abs deviation {worst:.3e} over "
          f"{len(buckets)} level buckets (tolerance {DESC_TOL})")
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


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    sys.path.insert(0, ROOT)
    from benches.data import SHIFT, make_pairs, make_volume, pair_ok
    from scripts.profile_register import profile_call
    from sift3d_tpu_torch import RegSift3D, _build
    from sift3d_tpu_torch.config import MatchParams
    from sift3d_tpu_torch.ops import cuda_match, cuda_window
    from sift3d_tpu_torch.ops.cuda_match import (reduce_one_way,
                                                 reduce_one_way_plain)

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

    src = make_volume((SIZE,) * 3, nblob=NBLOB, seed=SEED)
    ref = np.roll(src, SHIFT, axis=2)

    # 2. Kernel 1 against its plain version on the real pyramid levels.
    s3d = reg.sift
    kp_src, d_src = s3d.detect_and_extract(src)
    worst1 = check_descrip_window(s3d, kp_src)
    k1_args = level_args(s3d, kp_src)
    kp_ref, d_ref = s3d.detect_and_extract(ref)
    k1_args += level_args(s3d, kp_ref)

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
        res = r.register(src, ref)
        torch.cuda.synchronize()
        counts = (cuda_window.descrip_window.launches,
                  cuda_match.reduce_one_way.launches)
        ok = bool(res.ok and pair_ok(res.A) and not res.kp_overflow)
        print(f"register {SIZE}^3 ({label} matcher): ok={ok}, "
              f"matches {len(res.match_src)}, inliers {res.num_inliers}, "
              f"launches descrip_window {counts[0]} match_stream "
              f"{counts[1]}, A={np.round(res.A, 4).tolist()}")
        assert ok, f"{SIZE}^3 pair outside the contract ({label})"
        assert counts[0] > 0, "descrip_window never launched"
        runs[label] = dict(counts=counts, n_matches=len(res.match_src),
                           inliers=res.num_inliers, A=res.A.tolist())
    assert runs["streamed"]["counts"][1] > 0, "match_stream never launched"
    detail["runs"] = runs

    src4, ref4 = make_pairs(CONFIG4_PAIRS, (64, 64, 64))
    passed = []
    for s4, r4 in zip(src4, ref4):
        res = reg.register(s4, r4)
        passed.append(bool(res.ok and pair_ok(res.A)))
    rate = float(np.mean(passed))
    print(f"config-4 pairs: {sum(passed)}/{CONFIG4_PAIRS} pass the contract "
          f"(rate {rate:.3f}, gate {GATE_PASS_RATE})")
    assert rate >= GATE_PASS_RATE, rate
    detail["config4_pass_rate"] = rate

    # 5. Times (everything above was the warm-up).
    from sift3d_tpu_torch.ops.cuda_window import (descrip_window,
                                                  descrip_window_plain,
                                                  descrip_work)
    nbytes = ops = 0
    for _, a in k1_args:
        b, o = descrip_work(*a)
        nbytes += b
        ops += o
    b1, by1 = bound_ms(nbytes, ops)
    k1_ms = cuda_ms(lambda: [descrip_window(*a) for _, a in k1_args], 5)
    k1_plain = cuda_ms(lambda: [descrip_window_plain(*a) for _, a in k1_args],
                       1)
    detail["descrip_window"] = dict(
        buckets=[dict(level=lv, rows=a[3], cores=a[5]) for lv, a in k1_args],
        bytes=nbytes, ops=ops)

    def library(q, t, qs, ts):
        D = torch.clamp(qs[:, None] + ts[None, :] - 2.0 * (q @ t.T), min=0)
        return torch.topk(D, 2, dim=1, largest=False)

    def k2_times(args, reps):
        nq, nt = args[0].shape[0], args[1].shape[0]
        b, by = bound_ms((nq + nt) * 768 * 4 + (nq + nt) * 4 + nq * 12,
                         2.0 * nq * nt * 768)
        return dict(nq=nq, nt=nt,
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
    print(f"match_stream at 2500x2300 (one direction): "
          f"{k2_big['ms']:.4f} ms, plain {k2_big['plain_ms']:.4f} ms, "
          f"matmul+topk {k2_big['library_ms']:.4f} ms, bound "
          f"{k2_big['bound_ms']:.4f} ms [{card}]")

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
          f"busy): " + ", ".join(
              f"{k} {v['host_ms']:.2f} / {v['device_busy_ms']:.2f}"
              for k, v in prof["stages"].items())
          + f"; total {prof['wall_ms']:.2f}, device busy "
          f"{prof['device_busy_ms']:.2f}, idle share "
          f"{prof['idle_share']:.3f}; unprofiled register min of 3 "
          f"{min(calls):.2f} [{card}]")

    log("detail: " + json.dumps(detail))

    kernels = [
        dict(name="descrip_window", route="cuda",
             source="sift3d_tpu_torch/csrc/descrip_window.cu",
             replaces="sift3d_tpu/ops/pallas_window.py:49",
             launches=runs["default"]["counts"][0], max_abs_err=worst1,
             ms=k1_ms, plain_ms=k1_plain, bound_ms=b1, bound_by=by1,
             library_ms=None),
        dict(name="match_stream", route="cuda",
             source="sift3d_tpu_torch/csrc/match_stream.cu",
             replaces="sift3d_tpu/ops/pallas_match.py:63",
             launches=runs["streamed"]["counts"][1],
             max_abs_err=detail["match_check"]["max_abs_err"],
             ms=k2_main["ms"], plain_ms=k2_main["plain_ms"],
             bound_ms=k2_main["bound_ms"], bound_by=k2_main["bound_by"],
             library_ms=k2_main["library_ms"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
