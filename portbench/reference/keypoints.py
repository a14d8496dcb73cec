"""Keypoint container: a struct of tensors with a row count (a frozen
copy of the port's ``features/keypoints.py``). A set of a batch of
volumes has a leading B axis on every field and a (B,) count tensor;
volume b's rows past ``count[b]`` are padding."""

from __future__ import annotations

import dataclasses

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


FIELDS = ("x", "y", "z", "o", "s", "sd", "R")


def valid_rows(capacity: int, count, device) -> torch.Tensor:
    """(capacity,) or, for a (B,) count, (B, capacity) mask of rows below
    count."""
    count = torch.as_tensor(count, device=device)
    return torch.arange(capacity, device=device) < count[..., None]
