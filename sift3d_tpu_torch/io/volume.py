"""The Volume container: array data + physical units.

The analog of the reference's Image struct (imutil/imtypes.h:156-168) minus
the explicit strides (numpy/JAX arrays carry their own). Data is float32,
laid out (nz, ny, nx) or (nz, ny, nx, nc) with x fastest - the same memory
order as the reference's default stride (x-stride = nc, imutil.c:1453-1466).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Volume:
    data: np.ndarray                     # (nz, ny, nx) or (nz, ny, nx, nc)
    units: tuple[float, float, float] = (1.0, 1.0, 1.0)   # (ux, uy, uz) mm

    def __post_init__(self):
        if self.data.ndim not in (3, 4):
            raise ValueError(f"Volume data must be 3D or 4D, got shape "
                             f"{self.data.shape}")
        self.units = tuple(float(u) for u in self.units)
        if any(u <= 0 for u in self.units):
            raise ValueError(f"units must be positive, got {self.units}")

    @property
    def nc(self) -> int:
        return 1 if self.data.ndim == 3 else self.data.shape[3]

    @property
    def dims_xyz(self) -> tuple[int, int, int]:
        nz, ny, nx = self.data.shape[:3]
        return (nx, ny, nz)

    def channel(self, c: int) -> "Volume":
        """Single-channel view (im_channel, imutil.c:1929-1956)."""
        if self.data.ndim == 3:
            if c != 0:
                raise IndexError(c)
            return self
        return Volume(self.data[..., c], self.units)
