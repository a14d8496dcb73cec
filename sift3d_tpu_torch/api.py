"""User-facing API: keypoints, descriptors and pairwise registration
(the port of ``sift3d_tpu/api.py``; reference SIFT3D struct, reg/reg.c
and the Matlab toolbox surface): ``Sift3D`` (detect, extract,
extract_raw, dense), ``RegSift3D.register`` (with ``resample``) and
``register_tps``, ``warp``,
``assign_orientations``, ``validate_keypoints``, ``descriptors_from_rows``
and ``match_descriptors``. Images may be arrays, tensors or ``io.Volume``s,
whose units override the ``units`` arguments.

PyTorch runs eagerly, so the per-level buckets come straight from the
extrema counts: there are no static capacities to pick and no programs to
cache. Keypoints past ``max_kp_per_level`` / ``max_kp_per_octave`` are
dropped as in the JAX package, and reported as ``kp_overflow``.

Entry points run on the card unless ``device`` names another device; with
no card they raise instead of running on the CPU. Each stage runs inside a
``torch.profiler.record_function`` span named ``sift3d.<stage>``
(pyramid, extrema and orientation in ``features/detect.detect``,
descriptors and dense here, match, ransac and tps in
``register/pipeline``), which a
profiler trace reads as the stage breakdown. The batched entry points
(``parallel.pipeline``) use the same spans. Every copy of an input
volume to the device goes through ``ops/upload`` (``upload``, which
these entry points call with ``image_dtype``: a float image keeps its
type), inside its ``sift3d.upload`` span, just before
``sift3d.pyramid`` and outside it (a host stack that streams in
sub-batches, ``ops/upload.upload_parts``, alternates the two spans, one
pair a sub-batch). ``utils/trace`` keeps the
``sift3d.sync.<stage>`` spans, nested in their stage around each
deliberate device-to-host read (the extrema counts of every keypoint
level, orientation's keep, the descriptors' bucket sizes and per-volume
padding), and the process-wide counters, always on: the reads
(``sync.<stage>``), the bytes uploaded (``upload.bytes``) and those that
landed after their side's pyramid began (``upload.streamed_bytes``), the
host-to-device copies of blur operators (``conv.w_uploads``), the extrema rows
(``extrema.rows``), the keypoint levels searched (``extrema.levels``)
and those the CUDA kernels searched (``extrema.kernel_levels``), the
keypoints that orientation keeps (``orientation.kept``), the calls of
``batch_register_pairs`` and each kernel's launches
(``launches.<source>``); ``trace.counters()`` reads them out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from . import pyramid as pyr_mod
from .config import MatchParams, RansacParams, SIFT3DParams
from .dtypes import F64, full_fp32, resolve_device
from .features import detect as detect_mod
from .features import match as match_mod
from .features.dense import extract_dense_descriptors
from .features.descriptor import (Descriptors, extract_descriptors,
                                  extract_raw_descriptors)
from .features.keypoints import Keypoints
from .features.orientation import assign_orientations_raw
from .io import im_read, im_write  # noqa: F401  (re-exported)
from .io.volume import Volume
from .ops.interp import im_inv_transform, im_resample
from .ops.upload import image_dtype, upload
from .register.pipeline import register_pair, register_pair_tps


def _as_array(im):
    """(data, units or None): a Volume's units override the caller's."""
    if isinstance(im, Volume):
        return im.data, im.units
    return (im if torch.is_tensor(im) else np.asarray(im)), None


def _plan(shape_zyx, units, params):
    nz, ny, nx = shape_zyx[:3]
    return pyr_mod.plan_pyramid((nx, ny, nz), units, params)


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
        vol, vunits = _as_array(im)
        units = tuple(vunits or units)
        plan = _plan(vol.shape, units, self.params)
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

    def extract_raw(self, im, kp: Keypoints,
                    units=(1.0, 1.0, 1.0)) -> Descriptors:
        """Descriptors from a raw image and a keypoint list
        (SIFT3D_extract_raw_descriptors, sift.c:2131-2195): one kernel
        launch per non-empty level bucket."""
        data, vunits = _as_array(im)
        units = tuple(vunits or units)
        with record_function("sift3d.descriptors"):
            return extract_raw_descriptors(
                upload(data, self.device, image_dtype(data)),
                kp.to(self.device), units,
                _plan(data.shape, units, self.params), self.params)

    def dense(self, im, units=(1.0, 1.0, 1.0)) -> np.ndarray:
        """Dense descriptor image (12, nz, ny, nx) float32
        (SIFT3D_extract_dense_descriptors, sift.c:2354-2424);
        ``params.dense_rotate`` selects the rotation-invariant variant."""
        data, vunits = _as_array(im)
        units = tuple(vunits or units)
        with record_function("sift3d.dense"):
            out = extract_dense_descriptors(
                upload(data, self.device, image_dtype(data)), units,
                self.params)
        return out.cpu().numpy()


def assign_orientations(im, kp: Keypoints, units=(1.0, 1.0, 1.0),
                        params: SIFT3DParams = SIFT3DParams(), device=None):
    """Orientations and confidences of keypoints on a raw image
    (SIFT3D_assign_orientations, sift.c:1534-1607; the orientation3D.m
    analog), every level bucket in one kernel launch. Rejected keypoints
    get R = I and confidence -1. Returns numpy (R (K, 3, 3), conf (K,))."""
    dev = resolve_device(device)
    data, vunits = _as_array(im)
    units = tuple(vunits or units)
    with record_function("sift3d.orientation"):
        R, conf = assign_orientations_raw(
            upload(data, dev, image_dtype(data)), kp.to(dev), units,
            _plan(data.shape, units, params), params)
    return R.cpu().numpy(), conf.cpu().numpy()


def validate_keypoints(kp: Keypoints, dims_xyz=None,
                       tol: float = 1e-3) -> None:
    """Keypoint sanity checks mirroring keypoint3D.m / detectValidTest:
    in-bounds base-octave coordinates and orthogonal, right-handed
    rotations (Sift3DTest.m:245-274, keypoint3D.m:84-103).

    Raises ValueError on the first violation.
    """
    n = int(kp.count)
    if n == 0:
        return
    R = kp.R[:n].cpu().numpy()
    rtr = np.einsum("kij,kil->kjl", R, R)
    err = np.abs(rtr - np.eye(3)).max(axis=(1, 2))
    if (err > tol).any():
        raise ValueError(
            f"keypoint {int(np.argmax(err > tol))}: R is not orthogonal "
            f"(|R'R - I| = {err.max():.2e})")
    det = np.linalg.det(R)
    if (np.abs(det - 1.0) > tol).any():
        raise ValueError("rotation matrix determinant != +1 "
                         "(reflections are invalid orientations)")
    if dims_xyz is not None:
        f = 2.0 ** kp.o[:n].cpu().numpy()
        for c, (t, dim) in enumerate([(kp.x, dims_xyz[0]), (kp.y, dims_xyz[1]),
                                      (kp.z, dims_xyz[2])]):
            base = t[:n].cpu().numpy() * f
            if (base < 0).any() or (base > dim - 1).any():
                raise ValueError(
                    f"keypoint coordinate axis {c} out of bounds")


def descriptors_from_rows(rows, capacity: int | None = None,
                          device=None) -> Descriptors:
    """Rebuild a Descriptors set from CSV rows [x y z el0..el767]
    (SIFT3D_Descriptor_store_from_Mat_rm, sift.c:2721-2768) - the
    matchSift3D workflow of matching precomputed descriptor files."""
    dev = resolve_device(device)
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != 771:
        raise ValueError(f"descriptor rows must be (N, 771), got "
                         f"{rows.shape}")
    n = len(rows)
    cap = capacity or max(n, 1)

    def pad(a, dtype):
        out = np.zeros((cap,) + a.shape[1:], dtype)
        out[:min(n, cap)] = a[:cap]
        return torch.as_tensor(out, device=dev)
    return Descriptors(xyz=pad(rows[:, :3], np.float64),
                       sd=torch.zeros((cap,), dtype=F64, device=dev),
                       vec=pad(rows[:, 3:], np.float32), count=min(n, cap))


def match_descriptors(d1: Descriptors, d2: Descriptors,
                      nn_thresh: float = MatchParams().nn_thresh,
                      ssd_dtype=torch.float32) -> np.ndarray:
    """Match two descriptor sets; returns (N1,) int32 indices or -1
    (SIFT3D_nn_match, sift.c:2840-2888). ``ssd_dtype``: the SSD's
    precision (the reference accumulates in float64)."""
    return match_mod.nn_match(d1.vec, d2.vec, nn_thresh, d1.valid_mask(),
                              d2.valid_mask(), dtype=ssd_dtype).cpu().numpy()


@dataclasses.dataclass
class Registration:
    """Host-side registration result."""
    A: np.ndarray                  # (3, 4) voxel-space affine, ref -> src
    match_src: np.ndarray          # (M, 3) matched src coords
    match_ref: np.ndarray          # (M, 3) matched ref coords
    num_inliers: int
    ok: bool
    kp_overflow: bool              # keypoints dropped at a level capacity
    inlier_mask: np.ndarray        # (M,) bool: the affine's inliers (the
                                   # control points of ``register_tps``)


def _scale_descriptors(desc: Descriptors, factors) -> Descriptors:
    """scale_SIFT3D (reg.c:320-348): coords *= factors; sd *= det^(-1/3)."""
    factors = np.asarray(factors, np.float64)
    det = float(np.prod(factors))
    return Descriptors(
        xyz=desc.xyz * torch.as_tensor(factors, dtype=F64,
                                       device=desc.xyz.device)[None, :],
        sd=desc.sd * (det ** (-1.0 / 3.0)), vec=desc.vec, count=desc.count)


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

    def _describe(self, im, units):
        """Descriptors of one image and whether its keypoints overflowed."""
        _, desc = self.sift.detect_and_extract(im, units)
        return desc, self.sift.kp_overflow

    def register(self, src, ref, src_units=(1.0, 1.0, 1.0),
                 ref_units=(1.0, 1.0, 1.0), resample: bool = False,
                 interp: str = "linear") -> Registration:
        """register_SIFT3D / register_SIFT3D_resample (reg.c:239-429): the
        voxel-space affine mapping ref coords to src coords. With
        ``resample`` and units that differ, both images are resampled to
        the finer common units (``interp``: "linear" or "lanczos2") and
        registered there, with coordinates scaled back to the original
        voxel grids."""
        src_data, su = _as_array(src)
        ref_data, ru = _as_array(ref)
        src_units = tuple(su or src_units)
        ref_units = tuple(ru or ref_units)
        if resample and src_units != ref_units:
            units_min = tuple(min(a, b) for a, b in zip(src_units, ref_units))
            dev = self.sift.device
            descs = []
            for data, units in ((src_data, src_units), (ref_data, ref_units)):
                with record_function("sift3d.resample"):
                    im = im_resample(upload(data, dev, image_dtype(data)),
                                     units, units_min, interp)
                desc, over = self._describe(im, units_min)
                descs.append((_scale_descriptors(
                    desc, [um / u for um, u in zip(units_min, units)]), over))
            (d_src, over_src), (d_ref, over_ref) = descs
            # The reference registers in the resampled images' units
            # (reg->*_units are set from the interpolated images,
            # reg.c:183-229).
            reg_src_units = reg_ref_units = units_min
        else:
            d_src, over_src = self._describe(src_data, src_units)
            d_ref, over_ref = self._describe(ref_data, ref_units)
            reg_src_units, reg_ref_units = src_units, ref_units
        overflow = over_src or over_ref
        res = register_pair(d_src, d_ref, reg_src_units, reg_ref_units,
                            self.match_params, self.ransac_params,
                            kp_overflow=overflow)
        return _registration(res)

    def register_tps(self, src, ref, src_units=(1.0, 1.0, 1.0),
                     ref_units=(1.0, 1.0, 1.0), reg: float = 1e-6,
                     ransac_idx=None):
        """Nonrigid registration (``register_pair_tps``): the affine RANSAC
        for outlier rejection, then a thin-plate spline fit on its inliers,
        a capability the reference declares but never implemented
        (imutil.c:4504-4508). ``ransac_idx`` (H, 4) optionally injects the
        RANSAC hypothesis draws. Returns (Registration, Tps or None); the
        spline maps ref mm coordinates to src mm coordinates (warp with
        ``register.tps.im_inv_transform_tps``)."""
        src_data, su = _as_array(src)
        ref_data, ru = _as_array(ref)
        src_units = tuple(su or src_units)
        ref_units = tuple(ru or ref_units)
        d_src, over_src = self._describe(src_data, src_units)
        d_ref, over_ref = self._describe(ref_data, ref_units)
        if ransac_idx is not None:
            ransac_idx = torch.as_tensor(np.asarray(ransac_idx),
                                         device=self.sift.device)
        res, tps = register_pair_tps(
            d_src, d_ref, src_units, ref_units, self.match_params,
            self.ransac_params, reg=reg, ransac_idx=ransac_idx,
            kp_overflow=over_src or over_ref)
        return _registration(res), tps


def _registration(res) -> Registration:
    """The host-side Registration of a ``register_pair`` result."""
    n = res.num_matches
    return Registration(
        A=res.A.cpu().numpy(), match_src=res.match_src[:n].cpu().numpy(),
        match_ref=res.match_ref[:n].cpu().numpy(),
        num_inliers=res.num_inliers, ok=res.ok,
        kp_overflow=res.kp_overflow,
        inlier_mask=res.inlier_mask[:n].cpu().numpy())


def warp(src, A, out_shape_zyx=None, interp: str = "linear",
         device=None) -> np.ndarray:
    """Pull-warp src through the affine A (im_inv_transform,
    imutil.c:2040-2081); with ``Registration.A`` it warps src onto ref."""
    data, _ = _as_array(src)
    with record_function("sift3d.warp"):
        out = im_inv_transform(
            np.asarray(A, np.float64),
            upload(data, resolve_device(device), image_dtype(data)),
            out_shape_zyx, interp)
    return out.cpu().numpy()
