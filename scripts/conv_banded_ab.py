"""The dense and the framed convolution timed against each other on the
card (``sift3d_tpu_torch/ops/conv.py``).

    python3 scripts/conv_banded_ab.py [--sizes 128,192,256,384,512]
                                      [--reps 5] [--out FILE]

On n^3 fp32 volumes, for each axis length n, each tap set (the 256^3
pyramid plan's octave-0 incremental taps with the widest and the
narrowest band, and the dense descriptors' blur) and each axis (x, y,
z), times ``conv_axis`` (dense: n MACs a voxel) and the framed form at
tiles T of 64, 128 and 256 (T + 2H MACs a voxel), in turns, one call
each per turn by CUDA events, after a warm-up: the min and median of
``--reps`` turns, the achieved TFLOP/s of each form and its peak device
memory above the input. Every framed result is held to the dense one
within 2e-6 of the output's largest |value| first.

``pick`` applies the rule that sets ``BANDED_MIN_N`` and ``FRAME_TILE``
to such a table; ``check_composed`` holds ``apply_banded_matrix`` on
the 256^3 plan's composed pyramid operators to ``conv_axis``. Prints the
card's name and power limit, a line per (n, taps, axis), the rule's
choice beside the committed constants, and one JSON line; with ``--out``
the JSON also goes to that file. ``chip_smoke.py`` phase 11 runs the same
functions and asserts the committed constants are the rule's choice.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (128, 192, 256, 384, 512)
TILES = (64, 128, 256)
AXES = {"x": -1, "y": -2, "z": -3}
PLAN_SIZE = 256            # the pyramid plan whose taps and operators are used
GAIN = 0.95                # a form wins where its min is <= 95% of the other's
FRAMED_TOL = 2e-6          # framed vs dense, of the output's largest |value|
SENTINEL = 10 ** 9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def banded_min_n(n: int):
    """``conv.BANDED_MIN_N`` set to ``n`` inside the block."""
    from sift3d_tpu_torch.ops import conv
    saved = conv.BANDED_MIN_N
    conv.BANDED_MIN_N = n
    try:
        yield
    finally:
        conv.BANDED_MIN_N = saved


def plan_256():
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.config import SIFT3DParams
    return pyr.plan_pyramid((PLAN_SIZE,) * 3, (1.0, 1.0, 1.0),
                            SIFT3DParams())


def tap_sets() -> dict:
    """name -> taps: the pyramid's octave-0 incremental taps with the
    widest and the narrowest band, and the dense blur's taps."""
    from sift3d_tpu_torch.config import (DESC_SIG_FCTR, NHIST_PER_DIM,
                                         SIFT3DParams)
    from sift3d_tpu_torch.ops.conv import band_half_width, conv_matrix
    from sift3d_tpu_torch.ops.gauss import gauss_taps
    plan = plan_256()
    taps = [plan.octave_filter_taps(s)
            for s in range(plan.first_level + 1, plan.last_gpyr_level + 1)]
    H = [band_half_width(conv_matrix(t, 1.0, 1.0, PLAN_SIZE)) for t in taps]
    return {"pyramid_widest": taps[int(np.argmax(H))],
            "pyramid_narrowest": taps[int(np.argmin(H))],
            "dense_blur": gauss_taps(SIFT3DParams().sigma0 * DESC_SIG_FCTR /
                                     NHIST_PER_DIM)}


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def peak_bytes(fn, dev) -> int:
    """Peak device memory of ``fn()`` above what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated(dev) - base


def crossover(dev, sizes=SIZES, tiles=TILES, reps: int = 5,
              log=print) -> list[dict]:
    """The table: one row per (n, taps, axis), with the dense form's and
    each tile's framed form's times, rate, peak memory and deviation."""
    from sift3d_tpu_torch.ops import conv
    card = card_line()
    rows = []
    for n in sizes:
        g = torch.Generator(device=dev).manual_seed(n)
        vol = torch.randn((n,) * 3, generator=g, device=dev)
        voxels = float(vol.numel())
        for tname, taps in tap_sets().items():
            W = conv.conv_matrix(taps, 1.0, 1.0, n)
            H = conv.band_half_width(W)
            for aname, axis in AXES.items():
                forms = {"dense": (lambda axis=axis: conv.conv_axis(
                    vol, conv.conv_matrix(taps, 1.0, 1.0, n), axis))}
                macs = {"dense": n}
                for T in tiles:
                    Hf, tl = conv.banded_frame_tiles(W, T)
                    forms[T] = (lambda axis=axis, Hf=Hf, tl=tl:
                                conv._apply_frame_tiles(vol, Hf, tl, axis))
                    macs[T] = tl.shape[2]      # K = T + 2H
                want = forms["dense"]()
                scale = want.abs().max().item()
                devs = {T: (forms[T]() - want).abs().max().item() / scale
                        for T in tiles}
                del want
                for T, d in devs.items():
                    assert d <= FRAMED_TOL, \
                        f"framed T={T} vs dense at n={n} {tname} {aname}: {d}"
                times = {k: [] for k in forms}
                for f in forms.values():
                    f()
                torch.cuda.synchronize()
                for _ in range(reps):
                    for k, f in forms.items():
                        times[k].append(event_ms(f))

                def entry(k):
                    t = min(times[k])
                    return dict(min_ms=t, median_ms=float(np.median(times[k])),
                                tflops=2.0 * macs[k] * voxels / t / 1e9,
                                macs_per_voxel=macs[k],
                                peak_bytes=peak_bytes(forms[k], dev))
                row = dict(n=n, taps=tname, axis=aname, H=H,
                           dense=entry("dense"),
                           framed={T: dict(entry(T), max_rel_dev=devs[T])
                                   for T in tiles})
                rows.append(row)
                d = row["dense"]
                log(f"conv n={n} {tname} (H={H}) axis {aname}: dense "
                    f"{d['min_ms']:.4f} / {d['median_ms']:.4f} ms (min / "
                    f"median of {reps}), {d['tflops']:.2f} TFLOP/s, peak "
                    f"{d['peak_bytes'] / 2**20:.1f} MiB; " + "; ".join(
                        f"framed T={T} {f['min_ms']:.4f} / "
                        f"{f['median_ms']:.4f} ms, {f['tflops']:.2f} TFLOP/s, "
                        f"peak {f['peak_bytes'] / 2**20:.1f} MiB, dev "
                        f"{f['max_rel_dev']:.2e}"
                        for T, f in row["framed"].items()) + f" [{card}]")
        del vol
        torch.cuda.empty_cache()
    return rows


def pick(rows, tiles=TILES) -> tuple[int, int]:
    """(BANDED_MIN_N, FRAME_TILE) by the rule: the least measured n from
    which the framed form's min is at most GAIN of the dense form's, at
    that n and every larger measured n, on every axis and tap set, at the
    chosen tile (SENTINEL when there is none). The tile stays 128 unless
    another is at most GAIN of 128's at every such n, axis and tap set
    (the fastest of those in total if several are)."""
    ns = sorted({r["n"] for r in rows})

    def n_star(T):
        best = None
        for n in reversed(ns):
            if not all(r["framed"][T]["min_ms"] <= GAIN * r["dense"]["min_ms"]
                       for r in rows if r["n"] == n):
                break
            best = n
        return best
    first = n_star(128)
    if first is None:
        return SENTINEL, 128
    chosen = [r for r in rows if r["n"] >= first]
    wins = [T for T in tiles if T != 128 and all(
        r["framed"][T]["min_ms"] <= GAIN * r["framed"][128]["min_ms"]
        for r in chosen)]
    T = min(wins, key=lambda T: sum(r["framed"][T]["min_ms"]
                                    for r in chosen)) if wins else 128
    n = n_star(T)
    return (SENTINEL, 128) if n is None else (n, T)


def check_composed(dev, log=print) -> dict:
    """``apply_banded_matrix`` against ``conv_axis`` on every per-axis
    operator of the 256^3 plan's ``composed_pyramid_operators`` (level
    operators, square; seed operators, rectangular, take ``conv_axis`` in
    both), on a random volume of the octave's shape. Returns the branch
    counts and the largest deviation relative to the output's |max|."""
    from sift3d_tpu_torch import pyramid as pyr
    from sift3d_tpu_torch.ops import conv
    plan = plan_256()
    _, level_ops = pyr.composed_pyramid_operators(plan)
    g = torch.Generator(device=dev).manual_seed(3)
    branches = {"framed": 0, "dense": 0}
    worst = 0.0
    for (o, s), ops in sorted(level_ops.items()):
        nx, ny, nz = plan.octave_dims(o)
        vol = torch.randn((nz, ny, nx), generator=g, device=dev)
        for W, axis in zip(ops, (-1, -2, -3)):
            n = W.shape[0]
            H = conv.band_half_width(W)
            framed = min(conv.FRAME_TILE, n) + 2 * H < n
            branches["framed" if framed else "dense"] += 1
            want = conv.conv_axis(vol, W, axis)
            got = conv.apply_banded_matrix(vol, W, axis)
            worst = max(worst, (got - want).abs().max().item() /
                        want.abs().max().item())
    assert worst <= FRAMED_TOL, worst
    log(f"apply_banded_matrix on the {PLAN_SIZE}^3 plan's "
        f"{sum(branches.values())} composed level operators (axis by axis): {branches['framed']} "
        f"framed, {branches['dense']} fall back to the dense form; max "
        f"|dev| from conv_axis {worst:.3e} of the output's |max| (tolerance "
        f"{FRAMED_TOL}) [{card_line()}]")
    return dict(branches=branches, max_rel_dev=worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_banded_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sift3d_tpu_torch.dtypes import full_fp32
    from sift3d_tpu_torch.ops import conv
    full_fp32()
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    rows = crossover(dev, tuple(int(s) for s in args.sizes.split(",")),
                     reps=args.reps)
    composed = check_composed(dev)
    n, T = pick(rows)
    print(f"rule: BANDED_MIN_N {n}, FRAME_TILE {T}; committed "
          f"{conv.BANDED_MIN_N}, {conv.FRAME_TILE} [{card}]")
    out = json.dumps(dict(card=card, rows=rows, composed=composed,
                          pick=dict(banded_min_n=n, frame_tile=T)))
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
