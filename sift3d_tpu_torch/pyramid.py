"""Gaussian scale-space (GSS) and difference-of-Gaussian (DoG) pyramids.

Reproduces the reference pyramid geometry and blur schedule exactly
(reference sift3d/sift.c:938-1071, imutil/imutil.c:3752-3802,3858-3992),
as the JAX package's ``sift3d_tpu/pyramid.py`` does:

- first_octave = 0, first_level = -1
- num_gpyr_levels = num_kp_levels + 3, num_dog_levels = num_kp_levels + 2
- scale(o, s) = sigma0 * 2**(o + s / num_kp_levels)
- level dims halve per octave (integer division); units double per octave
- one bank of incremental filters built from the *first octave's* scales is
  reused at every octave with tap spacing ``1 / units[dim]`` voxels
  (build_gpyr passes unit=1.0, sift.c:1002)
- octave o+1 level first_level is a strided 2x downsample of octave o level
  max(s_end - 2, first_level) (sift.c:1029-1042, imutil.c:1742-1768).

The plan (shapes, scales, filter taps) is numpy on the host; the levels
are torch tensors on the input's device. A level is (nz, ny, nx) for one
volume or (B, nz, ny, nx) for a batch of volumes of one shape (the
non-sharded branch of ``build_gpyr_batched``,
``sift3d_tpu/parallel/pipeline.py``): every blur is one fp32 pass per
axis over the whole batch, dense or framed (``ops/conv.conv_sep``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .config import SIFT3DParams, num_octaves_for_dims
from .ops import conv
from .ops.gauss import gauss_taps, incremental_sigma


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


class Pyramid(dict):
    """A pyramid is a dict {(o, s): tensor(z, y, x)} plus its plan."""

    def __init__(self, plan: PyramidPlan, levels: dict):
        super().__init__(levels)
        self.plan = plan


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
    return _build_gpyr(vol, plan, None)


def _out(out, key):
    return None if out is None else out[key]


def _blurs(plan: PyramidPlan) -> list:
    """``conv.sep_keys`` of every blur of ``build_gpyr``."""
    first, keys = plan.first_level, []
    for o in range(plan.num_octaves):
        dims = plan.octave_dims(o)[::-1]
        units_o = plan.octave_units(o)
        if o == 0:
            keys += conv.sep_keys(plan.first_gauss_taps(), 1.0, units_o, dims)
        for s in range(first + 1, plan.last_gpyr_level + 1):
            keys += conv.sep_keys(plan.octave_filter_taps(s), 1.0, units_o,
                                  dims)
    return keys


def _build_gpyr(vol: torch.Tensor, plan: PyramidPlan, out) -> dict:
    """``build_gpyr``, each level written into ``out[(o, s)]`` (contiguous
    tensors of the levels' shapes) where ``out`` is given. Every blur's
    operators go to ``vol``'s device first, those missing in one copy."""
    conv.device_operators(_blurs(plan), vol.device, vol.dtype)
    first = plan.first_level
    last = plan.last_gpyr_level
    levels: dict = {}
    for o in range(plan.num_octaves):
        units_o = plan.octave_units(o)
        if o == 0:
            levels[(o, first)] = conv.apply_forms(
                vol, conv.sep_forms(vol, plan.first_gauss_taps(), 1.0,
                                    units_o), _out(out, (o, first)))
        else:
            # Strided 2x downsample of the previous octave's
            # downsample_level, with no extra blur (sift.c:1029-1042);
            # floor-halved dims (imutil.c:1748-1750).
            src = levels[(o - 1, plan.downsample_level)]
            nxd, nyd, nzd = plan.octave_dims(o)
            down = src[..., ::2, ::2, ::2][..., :nzd, :nyd, :nxd]
            levels[(o, first)] = down.contiguous() if out is None else \
                out[(o, first)].copy_(down)
        for s in range(first + 1, last + 1):
            taps = plan.octave_filter_taps(s)
            prev = levels[(o, s - 1)]
            levels[(o, s)] = conv.apply_forms(
                prev, conv.sep_forms(prev, taps, 1.0, units_o),
                _out(out, (o, s)))
    return levels


# --- octave-pipelined builder (composed per-axis operators) ----------------
#
# Every step of build_gpyr is a linear per-axis operator: a blur is a banded
# matrix (ops/conv.py) and the 2x downsample-pick a row selection. So the
# pyramid factors exactly into per-axis matrices composed on the host in
# float64 (the JAX package's pyramid.py:205-286):
#
#   seed(o)     = M_o  @ seed(0)          (M_o rectangular, n_o x n_base)
#   level(o, s) = C_os @ seed(o)          (C_os square, composed blurs)
#
# The dependency depth drops from 1 + num_octaves * (num_gpyr_levels - 2)
# convolutions to 3 (first blur, seed projection, level projection), equal
# to the sequential builder within float32 rounding.

def composed_pyramid_operators(plan: PyramidPlan):
    """Host-side composed per-axis operators of the pipelined builder.

    Returns ``(seed_ops, level_ops)``: ``seed_ops[o]`` the (x, y, z)
    matrices mapping the octave-0 seed (level ``(0, first)``) to octave o's
    seed (None for o = 0), ``level_ops[(o, s)]`` those mapping octave o's
    seed to level ``(o, s)`` for s > first; float32, composed in float64.
    """
    first = plan.first_level
    last = plan.last_gpyr_level
    ds = plan.downsample_level
    level_ops: dict = {}
    seed_ops: list = [None]
    # M per axis accumulates the seed projection; identity at octave 0.
    M = [np.eye(n, dtype=np.float64) for n in plan.dims]
    for o in range(plan.num_octaves):
        units_o = plan.octave_units(o)
        dims_o = plan.octave_dims(o)
        C = [np.eye(n, dtype=np.float64) for n in dims_o]
        for s in range(first + 1, last + 1):
            taps = plan.octave_filter_taps(s)
            for d, (n, u) in enumerate(zip(dims_o, units_o)):
                W = conv.conv_matrix(taps, 1.0, u, n).astype(np.float64)
                C[d] = W @ C[d]
            level_ops[(o, s)] = tuple(c.astype(np.float32) for c in C)
            if s == ds and o + 1 < plan.num_octaves:
                # Seed of the next octave: the strided 2x downsample-pick
                # of this level (sift.c:1029-1042) composed into M.
                for d, n_next in enumerate(plan.octave_dims(o + 1)):
                    M[d] = C[d][np.arange(n_next) * 2] @ M[d]
        if o + 1 < plan.num_octaves:
            seed_ops.append(tuple(m.astype(np.float32) for m in M))
    return seed_ops, level_ops


def _axis_form(W: np.ndarray) -> tuple:
    """How a composed per-axis operator is applied (``conv.apply_form``):
    framed (``conv.matrix_form``) for square matrices on axes of at least
    ``conv.BANDED_MIN_N`` voxels (``conv_sep``'s crossover), the dense
    matmul otherwise."""
    n_out, n_in = W.shape
    if n_out == n_in and n_in >= conv.BANDED_MIN_N:
        return conv.matrix_form(W)
    return None, W


def _forms(ops) -> tuple:
    """``composed_pyramid_operators``' result with each matrix in
    ``_axis_form``'s form."""
    seed_ops, level_ops = ops
    return ([None] + [tuple(map(_axis_form, m)) for m in seed_ops[1:]],
            {k: tuple(map(_axis_form, m)) for k, m in level_ops.items()})


@functools.lru_cache(maxsize=None)
def _plan_forms(plan: PyramidPlan, banded_min_n: int, tile: int) -> tuple:
    """``_forms`` of ``plan``'s composed operators, composed once a plan
    and framing rule (``conv.BANDED_MIN_N``, ``conv.FRAME_TILE``)."""
    return _forms(composed_pyramid_operators(plan))


def _pipelined_operators(plan: PyramidPlan, device, dtype) -> tuple:
    """``plan``'s composed operators in ``_axis_form``'s form with each
    array on ``device`` as ``dtype``, in ``composed_pyramid_operators``'
    layout. The copies, the first blur's operators among them, are kept
    in ``conv``'s device cache: the first call for a plan, device and
    dtype sends them all up in one copy, later calls none."""
    rule = (plan, conv.BANDED_MIN_N, conv.FRAME_TILE)
    seed_f, level_f = _plan_forms(*rule)
    named = {("seed", o, d): f for o, fs in enumerate(seed_f)
             if fs is not None for d, f in enumerate(fs)}
    named.update({("level", os, d): f for os, fs in level_f.items()
                  for d, f in enumerate(fs)})
    keys = [("composed", rule) + n for n in named]
    first = conv.sep_keys(plan.first_gauss_taps(), 1.0, plan.octave_units(0),
                          plan.octave_dims(0)[::-1])
    ops = conv.device_operators(
        keys + first, device, dtype,
        hosts={k: f[1] for k, f in zip(keys, named.values())})
    on = {n: (f[0], op) for (n, f), op in zip(named.items(), ops)}
    return ([None] + [tuple(on[("seed", o, d)] for d in range(3))
                      for o in range(1, len(seed_f))],
            {os: tuple(on[("level", os, d)] for d in range(3))
             for os in level_f})


def apply_sep_ops(vol: torch.Tensor, ops) -> torch.Tensor:
    """Apply per-axis (x, y, z) operators, x then y then z (the conv_sep
    order, imutil.c:3494-3526), to a volume or a batch."""
    return conv.apply_forms(vol, tuple(map(_axis_form, ops)))


def build_gpyr_pipelined(vol: torch.Tensor, plan: PyramidPlan,
                         ops=None) -> dict:
    """Octave-pipelined Gaussian pyramid: ``build_gpyr``'s levels, for a
    volume or a batch, equal to it within float32 rounding, each level at
    dependency depth 3. ``ops``: ``composed_pyramid_operators``' result,
    if the caller holds it (copied to the device on every call); without
    it the plan's operators are kept on the device
    (``_pipelined_operators``)."""
    return _build_gpyr_pipelined(vol, plan, None, ops)


def _build_gpyr_pipelined(vol: torch.Tensor, plan: PyramidPlan, out,
                          ops=None) -> dict:
    """``build_gpyr_pipelined``, each level written into ``out[(o, s)]``
    where ``out`` is given."""
    seed_ops, level_ops = _forms(ops) if ops is not None else \
        _pipelined_operators(plan, vol.device, vol.dtype)
    first = plan.first_level
    levels: dict = {}
    seed0 = conv.apply_forms(
        vol, conv.sep_forms(vol, plan.first_gauss_taps(), 1.0,
                            plan.octave_units(0)), _out(out, (0, first)))
    for o in range(plan.num_octaves):
        seed = seed0 if o == 0 else conv.apply_forms(
            seed0, seed_ops[o], _out(out, (o, first)))
        levels[(o, first)] = seed
        for s in range(first + 1, plan.last_gpyr_level + 1):
            levels[(o, s)] = conv.apply_forms(seed, level_ops[(o, s)],
                                              _out(out, (o, s)))
    return levels


def build_dog(gpyr: dict, plan: PyramidPlan) -> dict:
    """DoG levels: dog(o, s) = gpyr(o, s) - gpyr(o, s+1) (sift.c:1052-1071)."""
    return _build_dog(gpyr, plan, None)


def _build_dog(gpyr: dict, plan: PyramidPlan, out) -> dict:
    dog: dict = {}
    for o in range(plan.num_octaves):
        for s in range(plan.first_level, plan.last_dog_level + 1):
            dog[(o, s)] = torch.sub(gpyr[(o, s)], gpyr[(o, s + 1)],
                                    out=_out(out, (o, s)))
    return dog


def build_into(gpyr: dict, dog: dict, vols: torch.Tensor, sl: slice,
               n: int, plan: PyramidPlan, pipelined: bool = False) -> None:
    """The Gaussian and DoG pyramids of the raw volumes ``vols``, volumes
    ``sl`` of a batch of ``n``, put in the batch's levels ``gpyr`` and
    ``dog`` ({(o, s): (n, nz, ny, nx)}; empty dicts on the first call):
    ``im_scale``, every blur (with ``build_gpyr_pipelined`` when
    ``pipelined``) and DoG, written into the slice ``sl`` of levels made
    on the first call. Called once a sub-batch as each lands on the
    device, or once with the whole batch."""
    build = _build_gpyr_pipelined if pipelined else _build_gpyr
    if not gpyr:
        for levels, geoms in ((gpyr, plan.gpyr_levels()),
                              (dog, plan.dog_levels())):
            for g in geoms:
                levels[(g.o, g.s)] = vols.new_empty((n,) + g.dims[::-1])
    part = {k: v[sl] for k, v in gpyr.items()}
    build(im_scale(vols), plan, part)
    _build_dog(part, plan, {k: v[sl] for k, v in dog.items()})
