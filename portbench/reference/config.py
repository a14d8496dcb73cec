"""Constants and parameter dataclasses of the plain reference.

A frozen copy of the port's ``config.py`` (the same values, frozen
dataclasses and validation), plus ``F64``. They reproduce the original
SIFT3D parameter registry (sift3d/sift.c:34-55, reg/reg.c:24,
imutil/imutil.c:102-103). The benchmark builds the port's parameter
objects and these from the same configuration file.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F64 = torch.float64

# Algorithm constants (reference: sift3d/imtypes.h:79-95, sift3d/sift.c:48-58)
IM_NDIMS = 3
ICOS_NFACES = 20
ICOS_NVERT = 12
HIST_NUMEL = ICOS_NVERT            # icosahedral histogram bins per sub-histogram
NHIST_PER_DIM = 4
DESC_NUM_TOTAL_HIST = NHIST_PER_DIM ** 3   # 64
DESC_NUMEL = DESC_NUM_TOTAL_HIST * HIST_NUMEL  # 768

MAX_EIG_RATIO = 0.90               # sift.c:48
ORI_GRAD_THRESH = 1e-10            # sift.c:49
BARY_EPS = 1.1920929e-07 * 10.0    # FLT_EPSILON * 1e1, sift.c:50
ORI_SIG_FCTR = 1.5                 # sift.c:51
ORI_RAD_FCTR = 3.0                 # sift.c:52
DESC_SIG_FCTR = 7.071067812        # 5*sqrt(2), sift.c:53
DESC_RAD_FCTR = 2.0                # sift.c:54
# trunc_thresh = 0.2f * 128.0f / DESC_NUMEL (sift.c:55); computed in float32
TRUNC_THRESH = float(0.2 * 128.0 / DESC_NUMEL)
GOLDEN_RATIO = 1.6180339887        # sift.c:58

GAUSS_WIDTH_FCTR = 3.0             # imutil.c:3654-3656
CONV_EPS = 0.1                     # imutil.c:2284 (boundary mirror epsilon)
MIN_VOL_DIM = 8                    # sift.c:952-961

RANSAC_MIN_INLIERS = 5             # imutil.c:4787
SINGULAR_RCOND = 100.0 * 2.220446049250313e-16  # 100*DBL_EPSILON, imutil.c:3109


@dataclasses.dataclass(frozen=True)
class SIFT3DParams:
    """Detector/descriptor parameters (reference sift.c:34-38)."""
    peak_thresh: float = 0.1       # relative DoG peak threshold
    corner_thresh: float = 0.4     # minimum corner score
    num_kp_levels: int = 3         # keypoint levels per octave
    sigma_n: float = 1.15          # nominal input scale
    sigma0: float = 1.6            # base octave scale
    # Dense descriptors: the rotation-invariant variant (per-voxel
    # orientation, sift.c:2521-2588) instead of splat-and-blur.
    dense_rotate: bool = False
    # Per-level keypoint capacity (the reference grows its keypoint slab
    # without bound, immacros.h:199-222). Extrema past it are dropped and
    # reported as ``kp_overflow``.
    max_kp_per_level: int = 8192
    # Optional per-OCTAVE capacities (entry o applies to every level of
    # octave o; the last entry extends to deeper octaves).
    max_kp_per_octave: tuple[int, ...] | None = None

    def validate(self) -> None:
        # Mirrors set_*_SIFT3D validation (sift.c:514-580).
        if self.peak_thresh <= 0 or self.peak_thresh > 1:
            raise ValueError(f"invalid peak_thresh: {self.peak_thresh}")
        if self.corner_thresh < 0 or self.corner_thresh > 1:
            raise ValueError(f"invalid corner_thresh: {self.corner_thresh}")
        if self.num_kp_levels < 1:
            raise ValueError(f"invalid num_kp_levels: {self.num_kp_levels}")
        if self.sigma_n < 0:
            raise ValueError(f"invalid sigma_n: {self.sigma_n}")
        if self.sigma0 < 0:
            raise ValueError(f"invalid sigma0: {self.sigma0}")


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """RANSAC parameters (reference imutil.c:102-103).

    ``oversample``: num_iter*oversample hypotheses are drawn and the first
    num_iter non-singular ones kept, in place of the reference's
    redraw-until-nonsingular loop (imutil.c:4801-4803). ``seed`` seeds the
    ``torch.Generator`` that draws them.
    """
    err_thresh: float = 5.0
    num_iter: int = 500
    oversample: int = 2
    seed: int = 0

    def validate(self) -> None:
        if self.err_thresh < 0:
            raise ValueError(f"invalid err_thresh: {self.err_thresh}")
        if self.num_iter < 1:
            raise ValueError(f"invalid num_iter: {self.num_iter}")


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """Matching parameters (reference reg.c:24).

    ``impl`` selects the matcher: "xla" materializes the (N1, N2) SSD
    matrix (the name is kept from the JAX package), "streamed" uses the
    streamed top-2 kernel (O(N1 + N2) device memory), "auto" picks the
    streamed kernel on a CUDA tensor once the SSD matrix would reach
    ``streamed_threshold`` entries.
    """
    nn_thresh: float = 0.8
    impl: str = "auto"
    streamed_threshold: int = 4 * 1024 * 1024   # SSD entries (16 MB f32)

    def validate(self) -> None:
        if self.nn_thresh <= 0 or self.nn_thresh > 1:
            raise ValueError(f"invalid nn_thresh: {self.nn_thresh}")
        if self.impl not in ("auto", "xla", "streamed"):
            raise ValueError(f"invalid match impl: {self.impl}")


def num_octaves_for_dims(nx: int, ny: int, nz: int) -> int:
    """Number of pyramid octaves for a volume (reference sift.c:947-965).

    last_octave = floor(log2(min_dim)) - 3; octaves = last_octave + 1.
    Raises if the volume is smaller than 8 voxels in any dimension.
    """
    min_dim = min(nx, ny, nz)
    last_octave = int(math.log2(float(min_dim))) - 3
    if last_octave < 0:
        raise ValueError(
            "input image is too small: must have at least 8 voxels in each "
            f"dimension, got ({nx}, {ny}, {nz})")
    return last_octave + 1
