"""Device and precision rules of the port.

- ``F64``: the port computes in float64 wherever the JAX package uses
  ``f64()`` (per-keypoint coordinates, structure-tensor sums, RANSAC).
  The JAX package's parity tests run with x64 on, and fp64 per-keypoint
  math is cheap on the card.
- ``resolve_device``: entry points default to the card and refuse to run
  on the CPU unless the caller asks for it by name.
- ``full_fp32``: fp32 products run at full fp32, never TF32 - the
  counterpart of ``Precision.HIGHEST`` in the JAX package.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when the card is asked for and none is present,
    instead of carrying on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sift3d_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def full_fp32() -> None:
    """Turn off TF32 for fp32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
