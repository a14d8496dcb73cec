"""Detect keypoints and extract descriptors from one image, on the card.

The PyTorch port's counterpart of ``examples/features.py`` (the
reference's examples/featuresC.c): read an image, detect SIFT3D
keypoints, extract descriptors, and print summary stats.

Usage: python examples/torch/features.py image.nii.gz
"""

import sys

import numpy as np

from sift3d_tpu_torch.api import Sift3D
from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.io import im_read
from sift3d_tpu_torch.utils import StageTimer, set_log_fn


def main(path: str, device=None) -> int:
    device = resolve_device(device)
    set_log_fn(lambda rec: print(rec))
    vol = im_read(path)

    sift = Sift3D(device=device)
    timer = StageTimer("features")
    with timer.stage("detect") as out:
        kp = sift.detect(vol)
        out["kp"] = kp.x
    with timer.stage("extract") as out:
        desc = sift.extract(kp)
        out["desc"] = desc.vec
    timer.report()

    n = int(kp.count)
    rows = desc.to_numpy()
    print(f"detected {n} keypoints")
    print(f"descriptor matrix: {rows.shape}, norms ~ "
          f"{np.linalg.norm(rows[:, 3:], axis=1).mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
