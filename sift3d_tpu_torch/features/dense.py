"""Raw-image input of the descriptor and orientation paths.

``sift3d_tpu/features/dense.py`` holds the dense per-voxel descriptors
(reference SIFT3D_extract_dense_descriptors, sift3d/sift.c:2354-2424) and
the smoothing that the raw-image paths share with them; the port has the
smoothing so far (``smooth_scale_raw_input``), which
``features/orientation.assign_orientations_raw`` and
``features/descriptor.extract_raw_descriptors`` run first.
"""

from __future__ import annotations

import torch

from ..config import SIFT3DParams
from ..ops import conv
from ..ops.gauss import gauss_taps, incremental_sigma
from ..pyramid import im_scale


def smooth_scale_raw_input(vol: torch.Tensor, units,
                           params: SIFT3DParams) -> torch.Tensor:
    """sigma_n -> sigma0 blur + scale to [-1, 1] (sift.c:1978-2006) of a
    (nz, ny, nx) volume, on its device."""
    taps = gauss_taps(incremental_sigma(params.sigma_n, params.sigma0))
    return im_scale(conv.conv_sep(vol.to(torch.float32), taps, 1.0, units))
