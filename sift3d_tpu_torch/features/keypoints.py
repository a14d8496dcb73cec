"""Keypoint container: a struct of tensors with a row count.

The reference grows Keypoint slabs dynamically (imtypes.h:264-270,
immacros.h:199-222). The JAX package pads to static capacities; the port
runs eagerly, so the sets of one volume hold exactly ``count`` rows, and
``head`` keeps the JAX package's contract (rows >= count are padding) for
sets carried across with ``convert.keypoints_from_numpy``. A set of a
batch of volumes has a leading B axis on every field and a (B,) count
tensor; volume b's rows past ``count[b]`` are padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    count: int            # number of valid rows ((B,) tensor for a batch)

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        return valid_rows(self.capacity, self.count, self.x.device)

    def to(self, device) -> "Keypoints":
        """The same set with its tensors on ``device``."""
        return Keypoints(**{f: getattr(self, f).to(device) for f in FIELDS},
                         count=self.count)

    def to_numpy(self) -> np.ndarray:
        """Rows [x y z o sd R00..R22] (14 cols), trimmed to count."""
        n = self.count
        out = np.zeros((n, 14), np.float64)
        for c, t in enumerate((self.x, self.y, self.z, self.o, self.sd)):
            out[:, c] = t[:n].cpu().numpy()
        out[:, 5:] = self.R[:n].reshape(n, 9).cpu().numpy()
        return out


FIELDS = ("x", "y", "z", "o", "s", "sd", "R")


def valid_rows(capacity: int, count, device) -> torch.Tensor:
    """(capacity,) or, for a (B,) count, (B, capacity) mask of rows below
    count."""
    count = torch.as_tensor(count, device=device)
    return torch.arange(capacity, device=device) < count[..., None]


def concatenate(parts: list[Keypoints]) -> Keypoints:
    """Concatenate keypoint sets of one volume each, their rows below
    count in order, padded with zero rows to the parts' total capacity."""
    caps = sum(p.capacity for p in parts)
    n = sum(int(p.count) for p in parts)

    def cat(f):
        rows = torch.cat([getattr(p, f)[:int(p.count)] for p in parts])
        pad = rows.new_zeros((caps - n,) + tuple(rows.shape[1:]))
        return torch.cat([rows, pad])
    return Keypoints(**{f: cat(f) for f in FIELDS}, count=n)


def head(kp: Keypoints, n: int) -> Keypoints:
    """First ``n`` rows of a compacted keypoint set."""
    return Keypoints(**{f: getattr(kp, f)[:n] for f in FIELDS},
                     count=min(kp.count, n))
