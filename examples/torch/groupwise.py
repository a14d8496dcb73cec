"""Groupwise registration of several volumes, on the card.

The PyTorch port's counterpart of ``examples/groupwise.py``: jointly
estimates one affine per volume, consistent across all pairwise matches,
from one normal-equation system (sift3d_tpu_torch/register/groupwise.py).

Usage: python examples/torch/groupwise.py vol0.nii vol1.nii vol2.nii ...
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

from sift3d_tpu_torch.api import Sift3D
from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.features.descriptor import Descriptors
from sift3d_tpu_torch.io import im_read
from sift3d_tpu_torch.register import register_groupwise


def main(paths, device=None) -> int:
    device = resolve_device(device)
    if len(paths) < 2:
        print("need at least 2 volumes", file=sys.stderr)
        return 1
    sift = Sift3D(device=device)
    descs, units = [], None
    for p in paths:
        vol = im_read(p)
        units = units or vol.units
        kp = sift.detect(vol)
        descs.append(sift.extract(kp))
        print(f"{p}: {int(kp.count)} keypoints")

    # One batched set: each volume's rows padded to the largest capacity.
    cap = max(d.capacity for d in descs)

    def stack(field):
        xs = [getattr(d, field) for d in descs]
        return torch.stack([F.pad(x, (0, 0) * (x.ndim - 1) +
                                  (0, cap - x.shape[0])) for x in xs])
    batch = Descriptors(xyz=stack("xyz"), sd=stack("sd"), vec=stack("vec"),
                        count=torch.tensor([d.count for d in descs],
                                           device=device))

    # Star graph on volume 0 plus a chain for redundancy.
    n = len(paths)
    edges = [(0, i) for i in range(1, n)] + \
            [(i, i + 1) for i in range(1, n - 1)]
    res = register_groupwise(batch, np.asarray(edges), units)
    if not bool(res.ok):
        print("groupwise registration failed (weak edges?)", file=sys.stderr)
        print("edge inliers:", res.edge_inliers.cpu().numpy())
        return 1
    for i, p in enumerate(paths):
        print(f"A[{i}] ({p} -> {paths[0]} frame):")
        print(res.A[i].cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
