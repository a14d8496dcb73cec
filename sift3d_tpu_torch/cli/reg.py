"""regSift3D: pairwise volumetric registration.

CLI-compatible with the reference tool (cli/regSift3D.c) and with
``sift3d_tpu/cli/reg.py``: same options (--matches/--transform/--warped/
--concat/--keys/--lines, --nn_thresh/--err_thresh/--num_iter/--type/
--resample), same output formats and exit codes. The warped output is the
source pull-warped onto the reference grid with linear interpolation
(regSift3D.c:370-403). ``--type tps`` fits a thin-plate spline on the
affine's inliers (``RegSift3D.register_tps``, beyond the reference, whose
TPS fit is unimplemented), writes it with ``io.csv.write_tps`` and warps
through it; it refuses ``--resample``, as the JAX package's CLI does.
Runs on the card unless ``main`` is given another device:

    python -m sift3d_tpu_torch.cli.reg src.nii.gz ref.nii.gz \\
        --transform A.csv --matches matches.csv --warped warped.nii.gz
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..api import RegSift3D, warp
from ..cli.common import add_sift3d_options, sift3d_params
from ..config import MatchParams, RansacParams
from ..dtypes import resolve_device
from ..io import im_read, im_write
from ..io.csv import write_affine, write_matches, write_tps
from ..io.volume import Volume
from ..ops.draw import draw_matches
from ..register.tps import im_inv_transform_tps


def main(argv=None, device=None) -> int:
    md, rd = MatchParams(), RansacParams()
    p = argparse.ArgumentParser(
        prog="regSift3D", description="Matches SIFT3D features and "
        "registers a source image to a reference image.")
    p.add_argument("source", help="source (moving) image")
    p.add_argument("reference", help="reference (fixed) image")
    p.add_argument("--matches", help="output feature matches (.csv, .csv.gz)")
    p.add_argument("--transform", help="output transform params (.csv)")
    p.add_argument("--warped", help="output warped source image")
    p.add_argument("--concat", help="output concatenated src|ref image")
    p.add_argument("--keys", help="output keypoints drawn in concat image")
    p.add_argument("--lines", help="output match lines drawn in concat image")
    p.add_argument("--nn_thresh", type=float, default=md.nn_thresh,
                   help=f"NN ratio threshold (default: {md.nn_thresh})")
    p.add_argument("--err_thresh", type=float, default=rd.err_thresh,
                   help=f"RANSAC inlier threshold (default: {rd.err_thresh})")
    p.add_argument("--num_iter", type=int, default=rd.num_iter,
                   help=f"RANSAC iterations (default: {rd.num_iter})")
    p.add_argument("--type", default="affine",
                   choices=["affine", "tps"],
                   help="transformation type (default: affine; tps\nexceeds "
                        "the reference, whose TPS fit is unimplemented)")
    p.add_argument("--resample", action="store_true",
                   help="resample inputs to common physical resolution")
    add_sift3d_options(p)
    args = p.parse_args(argv)

    if not (args.matches or args.transform or args.warped or args.concat
            or args.keys or args.lines):
        p.error("No outputs specified.")
    if args.type == "tps" and args.resample:
        p.error("--resample is not supported with --type tps")
    device = resolve_device(device)

    src = im_read(args.source)
    ref = im_read(args.reference)

    reg = RegSift3D(
        params=sift3d_params(args),
        match_params=MatchParams(nn_thresh=args.nn_thresh),
        ransac_params=RansacParams(err_thresh=args.err_thresh,
                                   num_iter=args.num_iter),
        device=device)
    tps = None
    if args.type == "tps":
        result, tps = reg.register_tps(src, ref)
        if tps is None:
            print("regSift3D: no good model was found", file=sys.stderr)
            return 1
    else:
        result = reg.register(src, ref, resample=args.resample)
    if not result.ok:
        print("regSift3D: no good model was found", file=sys.stderr)
        return 1

    if args.matches:
        write_matches(args.matches, result.match_src, result.match_ref)
    if args.transform:
        if tps is not None:
            write_tps(args.transform, tps.params.cpu().numpy(),
                      tps.ctrl.cpu().numpy())
        else:
            write_affine(args.transform, result.A)
    if args.warped:
        if tps is not None:
            data = src.data[..., 0] if src.data.ndim == 4 else src.data
            warped = im_inv_transform_tps(
                tps, torch.as_tensor(data).to(device),
                out_shape_zyx=ref.data.shape[:3], src_units=src.units,
                ref_units=ref.units).cpu().numpy()
        else:
            warped = warp(src, result.A, out_shape_zyx=ref.data.shape[:3],
                          device=device)
        im_write(args.warped, Volume(warped, ref.units))
    if args.concat or args.keys or args.lines:
        drawn = draw_matches(src.data, ref.data, result.match_src,
                             result.match_ref)
        if args.concat:
            im_write(args.concat, Volume(drawn["background"], src.units))
        if args.keys:
            im_write(args.keys, Volume(drawn["keys"], src.units))
        if args.lines:
            im_write(args.lines, Volume(drawn["lines"], src.units))
    return 0


if __name__ == "__main__":
    sys.exit(main())
