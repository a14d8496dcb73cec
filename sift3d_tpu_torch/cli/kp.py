"""kpSift3D: detect keypoints and extract descriptors from one image.

CLI-compatible with the reference tool (cli/kpSift3D.c) and with
``sift3d_tpu/cli/kp.py``: same option names (--keys/--desc/--draw), same
CSV output formats, at least one output required. Runs on the card unless
``main`` is given another device:

    python -m sift3d_tpu_torch.cli.kp image.nii.gz --keys keys.csv \\
        --desc desc.csv.gz --draw keys.nii.gz
"""

from __future__ import annotations

import argparse
import sys

from ..api import Sift3D
from ..cli.common import add_sift3d_options, sift3d_params
from ..dtypes import resolve_device
from ..io import im_read, im_write
from ..io.csv import write_descriptors, write_keypoints
from ..io.volume import Volume
from ..ops.draw import draw_points


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(
        prog="kpSift3D",
        description="Detects SIFT3D keypoints and extracts their "
                    "descriptors from an image.")
    p.add_argument("image", help="input image (.nii, .nii.gz, .dcm, dir)")
    p.add_argument("--keys", help="output keypoints (.csv, .csv.gz)")
    p.add_argument("--desc", help="output descriptors (.csv, .csv.gz)")
    p.add_argument("--draw", help="draw keypoints into an image "
                                  "(.nii, .nii.gz, .dcm, dir)")
    add_sift3d_options(p)
    args = p.parse_args(argv)

    if not (args.keys or args.desc or args.draw):
        p.error("No outputs specified.")
    device = resolve_device(device)

    vol = im_read(args.image)
    sift = Sift3D(sift3d_params(args), device=device)
    kp = sift.detect(vol)

    if args.keys:
        write_keypoints(args.keys, kp.to_numpy())
    if args.desc:
        desc = sift.extract(kp)
        write_descriptors(args.desc, desc.to_numpy())
    if args.draw:
        rows = kp.to_numpy()
        # Coordinates in base-octave (image) space: xyz * 2^o
        # (kpSift3D draws Keypoint_store_to_Mat_rm output, sift.c:2597-2662).
        pts = rows[:, :3] * (2.0 ** rows[:, 3])[:, None]
        nz, ny, nx = vol.data.shape[:3]
        im_write(args.draw, Volume(draw_points(pts, (nx, ny, nz), 1),
                                   vol.units))
    return 0


if __name__ == "__main__":
    sys.exit(main())
