"""Register two images and warp the source onto the reference grid, on
the card.

The PyTorch port's counterpart of ``examples/register.py`` (the
reference's examples/registerC.c) - the canonical end-to-end flow:
read -> detect+extract x2 -> match -> RANSAC -> warp.

Usage: python examples/torch/register.py src.nii.gz ref.nii.gz warped.nii.gz
"""

import sys

from sift3d_tpu_torch.api import RegSift3D, warp
from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.io import im_read, im_write
from sift3d_tpu_torch.io.volume import Volume
from sift3d_tpu_torch.utils import stage_report


def main(src_path: str, ref_path: str, out_path: str, device=None) -> int:
    device = resolve_device(device)
    src = im_read(src_path)
    ref = im_read(ref_path)

    reg = RegSift3D(device=device)
    result = reg.register(src, ref)
    if not result.ok:
        print("no good model was found", file=sys.stderr)
        return 1

    print("affine (ref -> src voxels):")
    print(result.A)
    print(stage_report(registration=result))

    warped = warp(src, result.A, out_shape_zyx=ref.data.shape[:3],
                  device=device)
    im_write(out_path, Volume(warped, ref.units))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
