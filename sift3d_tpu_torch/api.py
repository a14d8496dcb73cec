"""User-facing API: keypoints, descriptors and pairwise registration
(the port of ``Sift3D`` and ``RegSift3D.register`` in
``sift3d_tpu/api.py``; reference SIFT3D struct and reg/reg.c).

PyTorch runs eagerly, so the per-level buckets come straight from the
extrema counts: there are no static capacities to pick and no programs to
cache. Keypoints past ``max_kp_per_level`` / ``max_kp_per_octave`` are
dropped as in the JAX package, and reported as ``kp_overflow``.

Entry points run on the card unless ``device`` names another device; with
no card they raise instead of running on the CPU. Each stage runs inside a
``torch.profiler.record_function`` span named ``sift3d.<stage>``
(pyramid, extrema and orientation in ``features/detect.detect``,
descriptors here, match and ransac in ``register/pipeline``), which a
profiler trace reads as the stage breakdown. The batched entry points
(``parallel.pipeline``) use the same spans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from . import pyramid as pyr_mod
from .config import MatchParams, RansacParams, SIFT3DParams
from .dtypes import full_fp32, resolve_device
from .features import detect as detect_mod
from .features.descriptor import Descriptors, extract_descriptors
from .features.keypoints import Keypoints
from .register.pipeline import register_pair


class Sift3D:
    """Detector/descriptor engine with a persistent pyramid (reference
    SIFT3D struct, imtypes.h:309-334)."""

    def __init__(self, params: SIFT3DParams = SIFT3DParams(), device=None):
        params.validate()
        self.params = params
        self.device = resolve_device(device)
        full_fp32()
        self._gpyr = None
        self._plan = None
        self._kp: Keypoints | None = None
        self.kp_overflow = False

    def detect(self, im, units=(1.0, 1.0, 1.0)) -> Keypoints:
        """Detect keypoints in a (nz, ny, nx) volume
        (SIFT3D_detect_keypoints, sift.c:1609-1641): a batch of one."""
        vol = im if torch.is_tensor(im) else np.asarray(im)
        nz, ny, nx = vol.shape
        plan = pyr_mod.plan_pyramid((nx, ny, nz), tuple(units), self.params)
        gpyr, kp, _, overflow = detect_mod.detect(vol[None], plan,
                                                  self.params, self.device)
        self._gpyr = {k: v[0] for k, v in gpyr.items()}
        self._plan, self._kp = plan, kp
        self.kp_overflow = bool(overflow[0])
        return kp

    def extract(self, kp: Keypoints | None = None) -> Descriptors:
        """Descriptors from the stored pyramid (SIFT3D_extract_descriptors,
        sift.c:2025-2046)."""
        if self._gpyr is None:
            raise RuntimeError("call detect() before extract()")
        with record_function("sift3d.descriptors"):
            return extract_descriptors(
                self._gpyr, self._kp if kp is None else kp, self._plan)

    def detect_and_extract(self, im, units=(1.0, 1.0, 1.0)):
        """Detect + extract. Returns (Keypoints, Descriptors)."""
        kp = self.detect(im, units)
        return kp, self.extract(kp)


@dataclasses.dataclass
class Registration:
    """Host-side registration result."""
    A: np.ndarray                  # (3, 4) voxel-space affine, ref -> src
    match_src: np.ndarray          # (M, 3) matched src coords
    match_ref: np.ndarray          # (M, 3) matched ref coords
    num_inliers: int
    ok: bool
    kp_overflow: bool              # keypoints dropped at a level capacity


class RegSift3D:
    """Pairwise registration pipeline (Reg_SIFT3D, reg/reg.c)."""

    def __init__(self, params: SIFT3DParams = SIFT3DParams(),
                 match_params: MatchParams = MatchParams(),
                 ransac_params: RansacParams = RansacParams(), device=None):
        match_params.validate()
        ransac_params.validate()
        self.sift = Sift3D(params, device=device)
        self.match_params = match_params
        self.ransac_params = ransac_params

    def register(self, src, ref, src_units=(1.0, 1.0, 1.0),
                 ref_units=(1.0, 1.0, 1.0)) -> Registration:
        """register_SIFT3D (reg.c:239-317): the voxel-space affine mapping
        ref coords to src coords."""
        src_units, ref_units = tuple(src_units), tuple(ref_units)
        _, d_src = self.sift.detect_and_extract(src, src_units)
        overflow = self.sift.kp_overflow
        _, d_ref = self.sift.detect_and_extract(ref, ref_units)
        overflow = overflow or self.sift.kp_overflow
        res = register_pair(d_src, d_ref, src_units, ref_units,
                            self.match_params, self.ransac_params,
                            kp_overflow=overflow)
        n = res.num_matches
        return Registration(
            A=res.A.cpu().numpy(),
            match_src=res.match_src[:n].cpu().numpy(),
            match_ref=res.match_ref[:n].cpu().numpy(),
            num_inliers=res.num_inliers, ok=res.ok, kp_overflow=overflow)
