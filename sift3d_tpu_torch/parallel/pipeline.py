"""Batched end-to-end pipelines on one GPU.

The port of ``batch_detect_describe`` and ``batch_register_pairs``
(``sift3d_tpu/parallel/pipeline.py``) on their unsharded branch: a batch
of B volumes of one shape runs each pyramid blur as one matmul over the
batch, each level's extrema as one pass, the orientation windows of
every level as one kernel launch and each level bucket's descriptor
windows as one, over the rows of all B volumes, and matching and RANSAC
as batched tensor algebra over the B
pairs. There is no mesh: the batch lives on one device. The stages run
inside the same ``sift3d.<stage>`` profiler spans as the single-volume
path (``api.py``).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..config import MatchParams, RansacParams, SIFT3DParams
from ..dtypes import full_fp32, resolve_device
from ..features import detect as detect_mod
from ..features.descriptor import Descriptors, extract_descriptors
from ..features.keypoints import FIELDS, Keypoints
from ..register.pipeline import RegistrationResult, register_pairs


def _per_volume(kp: Keypoints, desc: Descriptors, vol: torch.Tensor,
                n_vols: int):
    """The flat rows of a batch as (B, K) sets with (B,) counts, K the
    largest count; each volume keeps its rows in their order."""
    order = torch.argsort(vol, stable=True)
    counts = torch.bincount(vol, minlength=n_vols)
    K = int(counts.max())
    v = vol[order]
    pos = torch.arange(v.shape[0], device=v.device) - \
        (torch.cumsum(counts, 0) - counts)[v]

    def pad(t):
        out = t.new_zeros((n_vols, K) + t.shape[1:])
        out[v, pos] = t[order]
        return out
    kp_b = Keypoints(**{f: pad(getattr(kp, f)) for f in FIELDS},
                     count=counts)
    desc_b = Descriptors(xyz=pad(desc.xyz), sd=pad(desc.sd),
                         vec=pad(desc.vec), count=counts)
    return kp_b, desc_b


def batch_detect_describe(vols, plan, params: SIFT3DParams, device=None):
    """Detect + describe a batch of volumes on one device.

    Args:
      vols: (B, nz, ny, nx) raw volumes (numpy or torch), one shape, the
        one ``plan`` was made for (``pyramid.plan_pyramid``).
      params: SIFT3DParams; the level capacities bound each volume.
      device: the device to run on; None means the card (and raises
        without one).

    Returns (keypoints, descriptors, kp_overflow): sets with a leading
    batch axis and (B,) counts, and the (B,) flag of volumes that lost
    keypoints at a level capacity.
    """
    dev = resolve_device(device)
    full_fp32()
    gpyr, kp, vol, overflow = detect_mod.detect(vols, plan, params, dev)
    with record_function("sift3d.descriptors"):
        desc = extract_descriptors(gpyr, kp, plan, vol=vol)
        kp_b, desc_b = _per_volume(kp, desc, vol, overflow.shape[0])
    return kp_b, desc_b, overflow


def batch_register_pairs(src_vols, ref_vols, plan, params: SIFT3DParams,
                         units=(1.0, 1.0, 1.0),
                         match_params: MatchParams = MatchParams(),
                         ransac_params: RansacParams = RansacParams(),
                         device=None) -> RegistrationResult:
    """Register B volume pairs at once (BASELINE.json config 4).

    Returns a RegistrationResult with a leading batch axis: A[b] maps
    ref_vols[b] voxel coords onto src_vols[b] voxel coords, and
    ``num_matches``, ``num_inliers``, ``ok`` and ``kp_overflow`` are (B,)
    tensors; ``kp_overflow[b]`` is True where either volume of pair b lost
    keypoints at a level capacity.
    """
    dev = resolve_device(device)
    match_params.validate()
    ransac_params.validate()
    _, d_src, ov_src = batch_detect_describe(src_vols, plan, params, dev)
    _, d_ref, ov_ref = batch_detect_describe(ref_vols, plan, params, dev)
    return register_pairs(d_src, d_ref, units, units, match_params,
                          ransac_params, kp_overflow=ov_src | ov_ref)
