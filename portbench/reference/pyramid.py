"""Gaussian scale-space and difference-of-Gaussian pyramids.

A frozen copy of the port's ``pyramid.py`` (its sequential builder): the
original's pyramid geometry and blur schedule (sift3d/sift.c:938-1071,
imutil/imutil.c:3752-3802, 3858-3992). The plan is numpy on the host; the
levels are torch tensors, (nz, ny, nx) or (B, nz, ny, nx).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import conv
from .config import SIFT3DParams, num_octaves_for_dims
from .gauss import gauss_taps, incremental_sigma


def level_scale(o: int, s: int, sigma0: float, num_kp_levels: int) -> float:
    """scale(o, s) = sigma0 * 2^(o + s/num_kp_levels) (imutil.c:3972)."""
    return sigma0 * 2.0 ** (o + float(s) / num_kp_levels)


@dataclasses.dataclass(frozen=True)
class LevelGeom:
    """Static geometry of one pyramid level."""
    o: int
    s: int
    dims: tuple[int, int, int]      # (nx, ny, nz)
    units: tuple[float, float, float]  # (ux, uy, uz), mm per voxel
    scale: float                    # absolute scale parameter


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """Host-side static plan for GSS/DoG construction for one input shape."""
    dims: tuple[int, int, int]          # input (nx, ny, nz)
    units: tuple[float, float, float]   # input units
    params: SIFT3DParams
    num_octaves: int
    first_level: int                    # -1
    num_gpyr_levels: int
    num_dog_levels: int

    @property
    def last_gpyr_level(self) -> int:
        return self.first_level + self.num_gpyr_levels - 1

    @property
    def last_dog_level(self) -> int:
        return self.first_level + self.num_dog_levels - 1

    def octave_dims(self, o: int) -> tuple[int, int, int]:
        d = list(self.dims)
        for _ in range(o):
            d = [x // 2 for x in d]
        return tuple(d)

    def octave_units(self, o: int) -> tuple[float, float, float]:
        return tuple(u * (2.0 ** o) for u in self.units)

    def gpyr_level(self, o: int, s: int) -> LevelGeom:
        return LevelGeom(o, s, self.octave_dims(o), self.octave_units(o),
                         level_scale(o, s, self.params.sigma0,
                                     self.params.num_kp_levels))

    def gpyr_levels(self):
        """Every Gaussian level's geometry, octave by octave."""
        for o in range(self.num_octaves):
            for s in range(self.first_level, self.last_gpyr_level + 1):
                yield self.gpyr_level(o, s)

    def dog_levels(self):
        """Every DoG level's geometry (that of its Gaussian level)."""
        for o in range(self.num_octaves):
            for s in range(self.first_level, self.last_dog_level + 1):
                yield self.gpyr_level(o, s)

    def first_gauss_taps(self) -> np.ndarray:
        """Filter from sigma_n to scale(first_octave, first_level)."""
        p = self.params
        return gauss_taps(incremental_sigma(
            p.sigma_n,
            level_scale(0, self.first_level, p.sigma0, p.num_kp_levels)))

    def octave_filter_taps(self, s: int) -> np.ndarray:
        """Filter building level s from level s-1 (any octave): the
        incremental filter from scale(0, s-1) to scale(0, s) (sift.c:1020)."""
        p = self.params
        return gauss_taps(incremental_sigma(
            level_scale(0, s - 1, p.sigma0, p.num_kp_levels),
            level_scale(0, s, p.sigma0, p.num_kp_levels)))

    @property
    def downsample_level(self) -> int:
        """Level whose 2x downsample seeds the next octave (sift.c:1031)."""
        return max(self.last_gpyr_level - 2, self.first_level)


def plan_pyramid(dims: tuple[int, int, int],
                 units: tuple[float, float, float],
                 params: SIFT3DParams) -> PyramidPlan:
    """Compute the static pyramid plan (resize_SIFT3D, sift.c:938-986)."""
    params.validate()
    nx, ny, nz = dims
    num_octaves = num_octaves_for_dims(nx, ny, nz)
    num_dog_levels = params.num_kp_levels + 2
    num_gpyr_levels = num_dog_levels + 1
    return PyramidPlan(
        dims=tuple(dims), units=tuple(float(u) for u in units), params=params,
        num_octaves=num_octaves, first_level=-1,
        num_gpyr_levels=num_gpyr_levels, num_dog_levels=num_dog_levels)


def im_scale(vol: torch.Tensor) -> torch.Tensor:
    """Scale to [-1, 1] by the max absolute value (imutil.c:1959-1991),
    each volume of a batch by its own."""
    m = torch.amax(torch.abs(vol), dim=(-3, -2, -1), keepdim=True)
    return torch.where(m == 0, vol, vol / m)


def build_gpyr(vol: torch.Tensor, plan: PyramidPlan) -> dict:
    """Build the Gaussian pyramid from a scaled (nz, ny, nx) volume or
    (B, nz, ny, nx) batch.

    Returns {(o, s): tensor}.
    """
    first = plan.first_level
    last = plan.last_gpyr_level
    levels: dict = {}
    for o in range(plan.num_octaves):
        units_o = plan.octave_units(o)
        if o == 0:
            levels[(o, first)] = conv.conv_sep(vol, plan.first_gauss_taps(),
                                               1.0, units_o)
        else:
            # Strided 2x downsample of the previous octave's
            # downsample_level, with no extra blur (sift.c:1029-1042);
            # floor-halved dims (imutil.c:1748-1750).
            src = levels[(o - 1, plan.downsample_level)]
            nxd, nyd, nzd = plan.octave_dims(o)
            levels[(o, first)] = \
                src[..., ::2, ::2, ::2][..., :nzd, :nyd, :nxd].contiguous()
        for s in range(first + 1, last + 1):
            taps = plan.octave_filter_taps(s)
            levels[(o, s)] = conv.conv_sep(levels[(o, s - 1)], taps, 1.0,
                                           units_o)
    return levels


def build_dog(gpyr: dict, plan: PyramidPlan) -> dict:
    """DoG levels: dog(o, s) = gpyr(o, s) - gpyr(o, s+1) (sift.c:1052-1071)."""
    dog: dict = {}
    for o in range(plan.num_octaves):
        for s in range(plan.first_level, plan.last_dog_level + 1):
            dog[(o, s)] = gpyr[(o, s)] - gpyr[(o, s + 1)]
    return dog
