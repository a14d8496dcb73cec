"""Batched end-to-end pipelines, on one GPU or over a mesh of ranks.

The port of ``batch_detect_describe`` and ``batch_register_pairs``
(``sift3d_tpu/parallel/pipeline.py``). On one device (``mesh=None``) a
batch of B volumes of one shape runs each pyramid blur as one matmul over
the batch, each level's extrema as one pass, the orientation windows of
every level as one kernel launch and each level bucket's descriptor
windows as one, over the rows of all B volumes, and matching and RANSAC
as batched tensor algebra over the B pairs.

Over a mesh (``parallel.mesh.make_mesh``) every rank takes the same
global inputs and uploads only its block: its slice of the batch along
"data" and, where a level's extent along ``shard_dim`` splits into slabs
of at least 2 planes, its slab along "space". A level that does not split
is held whole on every rank of the axis. Each blur applies its sharded
pass with a halo exchange where the filter's band fits the slab
(``shard_conv``), and is computed whole otherwise; extrema and the
windows of the levels that split are sharded (``shard_extrema``,
``shard_windows``), the others run as on one device (kernels 3 and 1 on
the card). At space 1 each rank runs the one-device path on its slice.
Results are gathered over "data", so every rank returns the whole batch.
The stages run inside the same ``sift3d.<stage>`` profiler spans as the
single-volume path (``api.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from .. import pyramid as pyr_mod
from ..config import MatchParams, RansacParams, SIFT3DParams
from ..dtypes import F64, full_fp32, resolve_device
from ..features import detect as detect_mod
from ..features import extrema as extrema_mod
from ..features.descriptor import (Descriptors, extract_descriptors,
                                   extract_level, level_buckets)
from ..features.keypoints import FIELDS, Keypoints
from ..features.orientation import assign_orientations_level
from ..ops import conv
from ..ops.upload import upload, upload_start
from ..register.pipeline import RegistrationResult, register_pairs
from ..utils import trace
from .mesh import Mesh, all_gather_cat, mesh_device, pmax
from .shard_conv import DIMS, band_halo, conv_sep_sharded
from .shard_extrema import level_extrema_sharded
from .shard_windows import descrip_level_sharded, orient_level_sharded


def _by_volume(vol: torch.Tensor, n_vols: int, stage: str = "descriptors"):
    """Each row's place among its volume's rows (in row order), the rows
    of each volume, and the largest number of rows of a volume, read on
    the host as ``stage``'s one host sync (the rows are counted on the
    device: ``torch.bincount`` would read its input's min and max on the
    host first)."""
    counts = torch.zeros(n_vols, dtype=torch.long,
                         device=vol.device).index_add_(0, vol,
                                                       torch.ones_like(vol))
    order = torch.argsort(vol, stable=True)
    pos = torch.empty_like(vol)
    pos[order] = torch.arange(vol.shape[0], device=vol.device) - \
        (torch.cumsum(counts, 0) - counts)[vol[order]]
    K = 0
    if vol.numel():
        with trace.host_read(stage):
            K = int(counts.max())
    return pos, counts, K


def _pad(t: torch.Tensor, vol, pos, n_vols: int, K: int) -> torch.Tensor:
    """Flat rows as a zero-padded (n_vols, K, ...) batch."""
    out = t.new_zeros((n_vols, K) + t.shape[1:])
    out[vol, pos] = t
    return out


def _per_volume(kp: Keypoints, desc: Descriptors, vol: torch.Tensor,
                n_vols: int):
    """The flat rows of a batch as (B, K) sets with (B,) counts, K the
    largest count; each volume keeps its rows in their order."""
    pos, counts, K = _by_volume(vol, n_vols)

    def pad(t):
        return _pad(t, vol, pos, n_vols, K)
    kp_b = Keypoints(**{f: pad(getattr(kp, f)) for f in FIELDS},
                     count=counts)
    desc_b = Descriptors(xyz=pad(desc.xyz), sd=pad(desc.sd),
                         vec=pad(desc.vec), count=counts)
    return kp_b, desc_b


def _one_device(vols, plan, params, dev, pipelined: bool):
    """Detect + describe on one device: (B, K) sets and overflow flags."""
    gpyr, kp, vol, overflow = detect_mod.detect(vols, plan, params, dev,
                                                pipelined)
    with record_function("sift3d.descriptors"):
        desc = extract_descriptors(gpyr, kp, plan, vol=vol)
        kp_b, desc_b = _per_volume(kp, desc, vol, overflow.shape[0])
    return kp_b, desc_b, overflow


class _Slabs:
    """A rank's view of the levels of one call: a level of extent n along
    the sharded axis is held as this rank's slab where n splits into
    slabs of at least 2 planes (the JAX package's test for sharded extrema
    and windows), and whole otherwise."""

    def __init__(self, mesh: Mesh, shard_dim: str):
        self.mesh = mesh
        self.S = mesh.space
        self.sd = DIMS[shard_dim]
        self.shard_dim = shard_dim

    def splits(self, n: int) -> bool:
        return n % self.S == 0 and n // self.S >= 2

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole level (a view)."""
        L = x.shape[1 + self.sd] // self.S
        return x.narrow(1 + self.sd, self.mesh.s * L, L)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole level from every rank's slab."""
        return all_gather_cat(x, self.mesh, "space", 1 + self.sd)

    def held(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """A whole level of extent ``n`` as this rank holds it."""
        return self.slab(x) if self.splits(n) else x

    def full(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """A held level of extent ``n`` made whole."""
        return self.whole(x) if self.splits(n) else x


def _conv_shardable(taps, unit_dim: float, n: int, n_space: int) -> bool:
    """Whether a sharded halo conv is valid for this filter and extent."""
    return n_space > 1 and n % n_space == 0 and \
        band_halo(taps, 1.0, unit_dim, n) <= n // n_space


def _conv_level(x, taps, units_o, n: int, sl: _Slabs):
    """One blur of a held (B, nz, ny, nx) level of extent ``n`` along the
    sharded axis: its sharded pass with a halo exchange where the band
    fits the slab, the whole level otherwise."""
    if _conv_shardable(taps, units_o[2 - sl.sd], n, sl.S):
        xs = x if sl.splits(n) else sl.slab(x)
        out = conv_sep_sharded(xs, taps, 1.0, units_o, sl.mesh,
                               shard_dim=sl.shard_dim)
        return out if sl.splits(n) else sl.whole(out)
    return sl.held(conv.conv_sep(sl.full(x, n), taps, 1.0, units_o), n)


def build_gpyr_batched(vols: torch.Tensor, plan, mesh: Mesh,
                       pipelined: bool = False,
                       shard_dim: str = "z") -> dict:
    """Batched Gaussian pyramid {(o, s): level} of this rank's block.

    ``vols`` is the rank's block of a batch scaled to [-1, 1] per volume:
    its "data" slice, and its "space" slab of ``shard_dim`` where the
    extent splits (``_Slabs``); each level is held the same way. Mirrors
    ``pyramid.build_gpyr`` level for level. With ``pipelined=True`` at
    space 1 (the halo exchange is tap-based) the levels come from
    ``pyramid.build_gpyr_pipelined``, equal within float32 rounding.
    """
    if mesh.space == 1:
        build = pyr_mod.build_gpyr_pipelined if pipelined else \
            pyr_mod.build_gpyr
        return build(vols, plan)
    sl = _Slabs(mesh, shard_dim)
    first = plan.first_level
    levels: dict = {}
    for o in range(plan.num_octaves):
        units_o = plan.octave_units(o)
        n = plan.octave_dims(o)[2 - sl.sd]
        if o == 0:
            levels[(o, first)] = _conv_level(vols, plan.first_gauss_taps(),
                                             units_o, n, sl)
        else:
            src = sl.full(levels[(o - 1, plan.downsample_level)],
                          plan.octave_dims(o - 1)[2 - sl.sd])
            nxd, nyd, nzd = plan.octave_dims(o)
            down = src[:, ::2, ::2, ::2][:, :nzd, :nyd, :nxd].contiguous()
            levels[(o, first)] = sl.held(down, n)
        for s in range(first + 1, plan.last_gpyr_level + 1):
            levels[(o, s)] = _conv_level(levels[(o, s - 1)],
                                         plan.octave_filter_taps(s),
                                         units_o, n, sl)
    return levels


def _block(vols, mesh: Mesh, sl: _Slabs, dev) -> torch.Tensor:
    """This rank's block of a global (B, nz, ny, nx) batch, on ``dev``."""
    B = vols.shape[0]
    if B % mesh.data:
        raise ValueError(f"a batch of {B} does not split over "
                         f"{mesh.data} data ranks")
    b = B // mesh.data
    idx = [slice(mesh.d * b, (mesh.d + 1) * b), slice(None), slice(None),
           slice(None)]
    n = vols.shape[1 + sl.sd]
    if sl.S > 1 and sl.splits(n):
        L = n // sl.S
        idx[1 + sl.sd] = slice(mesh.s * L, (mesh.s + 1) * L)
    return upload(vols[tuple(idx)], dev, torch.float32)


def _rows_by_volume(rows: torch.Tensor, B: int):
    """(zyx (B, K, 3), vol, pos) of batch-form (n, 4) rows."""
    vol = rows[:, 0].long()
    pos, _, K = _by_volume(vol, B, "orientation")
    return _pad(rows[:, 1:], vol, pos, B, K), vol, pos


def _windows_sharded(gpyr: dict, ext: dict, plan, params: SIFT3DParams,
                     sl: _Slabs, B: int):
    """Orientation and descriptors of a sharded detection: the windows of
    the levels that split are summed over the slabs (``shard_windows``),
    the others run as on one device. Returns the flat keypoints, their
    descriptors and volume index, as ``orient_levels`` and
    ``extract_descriptors`` give them."""
    out = []
    with record_function("sift3d.orientation"):
        for o, s in detect_mod.kp_levels(plan):
            rows = ext[(o, s)][0]
            scale, units_o = plan.gpyr_level(o, s).scale, plan.octave_units(o)
            level = gpyr[(o, s)]
            if rows.shape[0] == 0:
                R = torch.zeros((0, 3, 3), device=level.device)
                valid = torch.zeros(0, dtype=torch.bool, device=level.device)
            elif sl.splits(plan.octave_dims(o)[2 - sl.sd]):
                zyx, vol, pos = _rows_by_volume(rows, B)
                R, valid = orient_level_sharded(
                    level, zyx, scale, units_o, params.corner_thresh,
                    sl.mesh, shard_dim=sl.shard_dim)
                R, valid = R[vol, pos], valid[vol, pos]
            else:
                R, valid = assign_orientations_level(
                    level, rows[:, 1:], scale, units_o, params.corner_thresh,
                    vol=rows[:, 0])
            out.append((rows, R, valid))
        rows, R, valid = (torch.cat(t) for t in zip(*out))
        kp, vol = detect_mod.keypoints_from_rows(
            rows, R, valid, [r.shape[0] for r, _, _ in out], plan)
    with record_function("sift3d.descriptors"):
        vec = torch.zeros((kp.capacity, 768), dtype=torch.float32,
                          device=kp.x.device)
        for (o, s), idx in level_buckets(kp, plan):
            centers = torch.stack([kp.z[idx], kp.y[idx], kp.x[idx]],
                                  -1).float()
            scale, units_o = plan.gpyr_level(o, s).scale, plan.octave_units(o)
            v = vol[idx]
            if sl.splits(plan.octave_dims(o)[2 - sl.sd]):
                pos, _, K = _by_volume(v, B)
                d = descrip_level_sharded(
                    gpyr[(o, s)], _pad(centers, v, pos, B, K),
                    _pad(kp.R[idx], v, pos, B, K), scale, units_o, sl.mesh,
                    shard_dim=sl.shard_dim)
                vec[idx] = d[v, pos]
            else:
                vec[idx] = extract_level(gpyr[(o, s)], centers, kp.R[idx],
                                         scale, units_o, vol=v)
        factor = torch.exp2(kp.o.to(F64))
        xyz = torch.stack([kp.x * factor, kp.y * factor, kp.z * factor], -1)
        desc = Descriptors(xyz=xyz, sd=kp.sd, vec=vec, count=kp.count)
    return kp, desc, vol


def _sharded(vols, plan, params, mesh: Mesh, shard_dim: str, dev):
    """Detect + describe this rank's block at space > 1: (B, K) sets of
    the rank's data slice and their overflow flags."""
    sl = _Slabs(mesh, shard_dim)
    x = _block(vols, mesh, sl, dev)
    B = x.shape[0]
    with record_function("sift3d.pyramid"):
        m = torch.amax(torch.abs(x), dim=(1, 2, 3))
        if sl.splits(plan.octave_dims(0)[2 - sl.sd]):
            m = pmax(m, mesh, "space")      # each volume's max of all slabs
        m = m[:, None, None, None]
        gpyr = build_gpyr_batched(torch.where(m == 0, x, x / m), plan, mesh,
                                  shard_dim=shard_dim)
        dog = pyr_mod.build_dog(gpyr, plan)
    ext, whole = {}, []
    with record_function("sift3d.extrema"):
        for o, s in detect_mod.kp_levels(plan):
            cap = detect_mod.level_cap(plan, o, params)
            levels = (dog[(o, s - 1)], dog[(o, s)], dog[(o, s + 1)])
            if sl.splits(plan.octave_dims(o)[2 - sl.sd]):
                ext[(o, s)] = level_extrema_sharded(
                    *levels, params.peak_thresh, cap, mesh,
                    shard_dim=shard_dim)
            else:
                whole.append(((o, s), levels + (cap,)))
        # The levels no slab splits: all in one call (one host read).
        ext.update(zip([k for k, _ in whole], extrema_mod.extrema_levels(
            [lv for _, lv in whole], params.peak_thresh)))
    ext = {k: ext[k] for k in detect_mod.kp_levels(plan)}
    kp, desc, vol = _windows_sharded(gpyr, ext, plan, params, sl, B)
    kp_b, desc_b = _per_volume(kp, desc, vol, B)
    return kp_b, desc_b, detect_mod.overflow_flags(ext)


def _local(vols, plan, params, mesh: Mesh, pipelined: bool, shard_dim: str,
           dev):
    """This rank's part of a meshed detection: the sets of its data
    slice."""
    if mesh.space == 1:
        sl = _Slabs(mesh, shard_dim)
        return _one_device(_block(vols, mesh, sl, dev), plan, params, dev,
                           pipelined)
    return _sharded(vols, plan, params, mesh, shard_dim, dev)


def _gather(t: torch.Tensor, mesh: Mesh, fill=0) -> torch.Tensor:
    """Every data rank's (b, K_r, ...) block, padded to the largest K_r
    with ``fill``, joined along the batch axis ((b,) blocks as they are)."""
    if t.ndim >= 2:
        K = int(pmax(torch.tensor([t.shape[1]], device=t.device), mesh,
                     "data")[0])
        if K > t.shape[1]:
            pad = t.new_full((t.shape[0], K - t.shape[1]) + t.shape[2:],
                             fill)
            t = torch.cat([t, pad], 1)
    return all_gather_cat(t, mesh, "data", 0)


def batch_detect_describe(vols, plan, params: SIFT3DParams, device=None,
                          mesh: Mesh | None = None, pipelined: bool = False,
                          shard_dim: str = "z"):
    """Detect + describe a batch of volumes.

    Args:
      vols: (B, nz, ny, nx) raw volumes (numpy or torch, or on one device
        the Pending of ``ops/upload.upload_start``), one shape, the one
        ``plan`` was made for (``pyramid.plan_pyramid``); over a mesh,
        the same whole batch on every rank (B divisible by ``data``).
      params: SIFT3DParams; the level capacities bound each volume.
      device: the device to run on; None means the card (and raises
        without one). A mesh must be on the same kind of device.
      mesh: None for one device; else the ranks' mesh: volumes over
        "data", the ``shard_dim`` axis ("z"/"y"/"x") over "space".
      pipelined: build the pyramid with the composed operators
        (``pyramid.build_gpyr_pipelined``; at space 1 only, as in JAX).

    Returns (keypoints, descriptors, kp_overflow): sets with a leading
    batch axis and (B,) counts, and the (B,) flag of volumes that lost
    keypoints at a level capacity; the whole batch on every rank.
    """
    full_fp32()
    if mesh is None:
        return _one_device(vols, plan, params, resolve_device(device),
                           pipelined)
    dev = mesh_device(mesh, device)
    kp, desc, ov = _local(vols, plan, params, mesh, pipelined, shard_dim,
                          dev)
    kp = Keypoints(**{f: _gather(getattr(kp, f), mesh) for f in FIELDS},
                   count=_gather(kp.count, mesh))
    desc = Descriptors(**{f: _gather(getattr(desc, f), mesh)
                          for f in ("xyz", "sd", "vec", "count")})
    return kp, desc, _gather(ov, mesh)


# Padding of each RegistrationResult field when gathered over "data".
_RESULT_FILL = dict(matches=-1)


def batch_register_pairs(src_vols, ref_vols, plan, params: SIFT3DParams,
                         units=(1.0, 1.0, 1.0),
                         match_params: MatchParams = MatchParams(),
                         ransac_params: RansacParams = RansacParams(),
                         device=None, mesh: Mesh | None = None,
                         pipelined: bool = False) -> RegistrationResult:
    """Register B volume pairs at once (BASELINE.json config 4).

    Returns a RegistrationResult with a leading batch axis: A[b] maps
    ref_vols[b] voxel coords onto src_vols[b] voxel coords, and
    ``num_matches``, ``num_inliers``, ``ok`` and ``kp_overflow`` are (B,)
    tensors; ``kp_overflow[b]`` is True where either volume of pair b lost
    keypoints at a level capacity. Over a ``mesh`` (as
    ``batch_detect_describe``) each data rank registers its slice of the
    pairs and every rank returns all B; padded match rows are -1.
    """
    match_params.validate()
    ransac_params.validate()
    trace.count("calls.batch_register_pairs")
    if mesh is None:
        dev = resolve_device(device)
        # Both stacks go up on the upload worker, in turn and without a
        # pause: each side builds its pyramid sub-batch by sub-batch as
        # its stack lands (``detect``), and the ref stack goes up under
        # the src side's work. The call never ends while the worker reads
        # them.
        ups = []
        try:
            for vols in (src_vols, ref_vols):
                ups.append(upload_start(vols, dev, torch.float32))
            trace.count("upload.ahead_bytes", ups[1].nbytes)
            _, d_src, ov_src = batch_detect_describe(ups[0], plan, params,
                                                     dev, pipelined=pipelined)
            _, d_ref, ov_ref = batch_detect_describe(ups[1], plan, params,
                                                     dev, pipelined=pipelined)
        finally:
            for up in ups:
                up.wait()
        return register_pairs(d_src, d_ref, units, units, match_params,
                              ransac_params, kp_overflow=ov_src | ov_ref)
    dev = mesh_device(mesh, device)
    full_fp32()
    _, d_src, ov_src = _local(src_vols, plan, params, mesh, pipelined, "z",
                              dev)
    _, d_ref, ov_ref = _local(ref_vols, plan, params, mesh, pipelined, "z",
                              dev)
    res = register_pairs(d_src, d_ref, units, units, match_params,
                         ransac_params, kp_overflow=ov_src | ov_ref)
    return RegistrationResult(**{
        f.name: _gather(getattr(res, f.name), mesh,
                        _RESULT_FILL.get(f.name, 0))
        for f in dataclasses.fields(RegistrationResult)})
