"""Shared CLI option handling.

Mirrors parse_args_SIFT3D (reference sift3d/sift.c:754-879): every tool
accepts --peak_thresh, --corner_thresh, --num_kp_levels, --sigma_n and
--sigma0 with the reference defaults, plus GNU --help/--version
(parse_gnu, imutil.c:4891-4922). The options, defaults and version line
are those of ``sift3d_tpu/cli/common.py``.
"""

from __future__ import annotations

import argparse

from ..config import SIFT3DParams

VERSION = "sift3d-tpu 0.1 (capability parity target: SIFT3D 1.4.6)"


def add_sift3d_options(p: argparse.ArgumentParser) -> None:
    d = SIFT3DParams()
    g = p.add_argument_group("SIFT3D detector options")
    g.add_argument("--peak_thresh", type=float, default=d.peak_thresh,
                   help="DoG peak threshold, relative to the per-level max "
                        f"(default: {d.peak_thresh})")
    g.add_argument("--corner_thresh", type=float, default=d.corner_thresh,
                   help=f"corner score threshold (default: {d.corner_thresh})")
    g.add_argument("--num_kp_levels", type=int, default=d.num_kp_levels,
                   help="keypoint levels per octave "
                        f"(default: {d.num_kp_levels})")
    g.add_argument("--sigma_n", type=float, default=d.sigma_n,
                   help=f"nominal input scale (default: {d.sigma_n})")
    g.add_argument("--sigma0", type=float, default=d.sigma0,
                   help=f"base scale of the pyramid (default: {d.sigma0})")
    p.add_argument("--version", action="version", version=VERSION)


def sift3d_params(args, **overrides) -> SIFT3DParams:
    params = SIFT3DParams(
        peak_thresh=args.peak_thresh, corner_thresh=args.corner_thresh,
        num_kp_levels=args.num_kp_levels, sigma_n=args.sigma_n,
        sigma0=args.sigma0, **overrides)
    params.validate()
    return params
