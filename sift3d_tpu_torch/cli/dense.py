"""denseSift3D: dense gradient-histogram image.

CLI-compatible with the reference tool (cli/denseSift3D.c) and with
``sift3d_tpu/cli/dense.py``: the output path must contain a '%', which is
replaced by the channel index 0..11; each of the 12 histogram channels is
written as an image of its own. Runs on the card unless ``main`` is given
another device:

    python -m sift3d_tpu_torch.cli.dense image.nii.gz out%.nii.gz
"""

from __future__ import annotations

import argparse
import sys

from ..api import Sift3D
from ..cli.common import add_sift3d_options, sift3d_params
from ..dtypes import resolve_device
from ..io import im_read, im_write
from ..io.volume import Volume


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(
        prog="denseSift3D",
        description="Extracts a dense gradient histogram image; the last "
        "'%%' in the output name is replaced by the channel index.")
    p.add_argument("input", help="input image")
    p.add_argument("output", help="output image pattern, e.g. out%%.nii.gz")
    add_sift3d_options(p)
    args = p.parse_args(argv)

    marker = args.output.rfind("%")
    if marker < 0:
        p.error("output filename must contain the '%' marker")
    device = resolve_device(device)

    vol = im_read(args.input)
    sift = Sift3D(sift3d_params(args), device=device)
    desc = sift.dense(vol)

    for c in range(desc.shape[0]):
        out_name = args.output[:marker] + str(c) + args.output[marker + 1:]
        im_write(out_name, Volume(desc[c], vol.units))
    return 0


if __name__ == "__main__":
    sys.exit(main())
