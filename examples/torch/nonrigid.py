"""Nonrigid (thin-plate-spline) registration - beyond the reference - on
the card.

The PyTorch port's counterpart of ``examples/nonrigid.py``. The reference
declares a TPS transform but never implemented its fit
(imutil.c:4504-4508), so its regSift3D only accepts --type affine. Here
affine RANSAC rejects outliers, a TPS interpolates the inlier
correspondences, and the source is pull-warped through the spline.

Usage: python examples/torch/nonrigid.py src.nii ref.nii warped.nii
"""

import sys

import torch

from sift3d_tpu_torch.api import RegSift3D
from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.io import im_read, im_write
from sift3d_tpu_torch.io.volume import Volume
from sift3d_tpu_torch.register.tps import im_inv_transform_tps


def main(argv, device=None):
    device = resolve_device(device)
    src = im_read(argv[0])
    ref = im_read(argv[1])
    reg = RegSift3D(device=device)
    result, tps = reg.register_tps(src, ref)
    if tps is None:
        print("no good model was found", file=sys.stderr)
        return 1
    print(f"{len(result.match_src)} matches, {result.num_inliers} "
          f"affine inliers, {tps.ctrl.shape[0]} TPS control points")
    data = src.data[..., 0] if src.data.ndim == 4 else src.data
    warped = im_inv_transform_tps(
        tps, torch.as_tensor(data, device=device),
        out_shape_zyx=ref.data.shape[:3], src_units=src.units,
        ref_units=ref.units).cpu().numpy()
    im_write(argv[2], Volume(warped, ref.units))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
