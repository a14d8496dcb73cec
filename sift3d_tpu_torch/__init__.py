"""PyTorch/CUDA port of sift3d_tpu for NVIDIA Hopper GPUs.

Runs the pairwise registration path of the JAX package
(``RegSift3D.register``): Gaussian and DoG pyramids, extrema,
structure-tensor orientation, icosahedral descriptors (a hand-written
CUDA kernel on the card), ratio-test matching (a streamed CUDA top-2
kernel for large sets) and RANSAC. It imports neither JAX nor the JAX
package; ``sift3d_tpu`` stays the reference it is tested against.
"""

from .api import Registration, RegSift3D, Sift3D
from .config import MatchParams, RansacParams, SIFT3DParams

__all__ = ["MatchParams", "RansacParams", "RegSift3D", "Registration",
           "SIFT3DParams", "Sift3D"]
