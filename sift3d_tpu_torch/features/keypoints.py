"""Keypoint container: a struct of tensors with a row count.

The reference grows Keypoint slabs dynamically (imtypes.h:264-270,
immacros.h:199-222). The JAX package pads to static capacities; the port
runs eagerly, so its own sets hold exactly ``count`` rows, and ``head`` /
``concatenate`` keep the JAX package's contract (rows >= count are
padding) for sets carried across with ``convert.keypoints_from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dtypes import F64


@dataclasses.dataclass
class Keypoints:
    """Keypoint set. Fields mirror the reference Keypoint
    (imtypes.h:253-261): coordinates are in *octave* space; ``sd`` is the
    absolute scale; ``R`` the 3x3 rotation."""
    x: torch.Tensor       # (K,) f64 octave-space coords
    y: torch.Tensor
    z: torch.Tensor
    o: torch.Tensor       # (K,) i32 octave index
    s: torch.Tensor       # (K,) i32 level index
    sd: torch.Tensor      # (K,) f64 absolute scale
    R: torch.Tensor       # (K, 3, 3) f32 rotation (rows x cols as reference)
    count: int            # number of valid rows

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.x.device) < self.count

    def to_numpy(self) -> np.ndarray:
        """Rows [x y z o sd R00..R22] (14 cols), trimmed to count."""
        n = self.count
        out = np.zeros((n, 14), np.float64)
        for c, t in enumerate((self.x, self.y, self.z, self.o, self.sd)):
            out[:, c] = t[:n].cpu().numpy()
        out[:, 5:] = self.R[:n].reshape(n, 9).cpu().numpy()
        return out


_FIELDS = ("x", "y", "z", "o", "s", "sd", "R")


def head(kp: Keypoints, n: int) -> Keypoints:
    """First ``n`` rows of a compacted keypoint set."""
    return Keypoints(**{f: getattr(kp, f)[:n] for f in _FIELDS},
                     count=min(kp.count, n))


def concatenate(parts: list[Keypoints]) -> Keypoints:
    """Concatenate keypoint sets, keeping the valid rows of each in order.
    The result holds exactly the valid rows (capacity == count)."""
    cols = {f: torch.cat([getattr(p, f)[:p.count] for p in parts])
            for f in _FIELDS}
    cols["x"], cols["y"], cols["z"], cols["sd"] = (
        cols[f].to(F64) for f in ("x", "y", "z", "sd"))
    cols["o"], cols["s"] = cols["o"].int(), cols["s"].int()
    cols["R"] = cols["R"].float()
    return Keypoints(**cols, count=sum(p.count for p in parts))
