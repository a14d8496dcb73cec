"""Groupwise multi-volume registration on one device.

The port of ``sift3d_tpu/register/groupwise.py`` (its single-device part).
A capability with no reference analog (SURVEY §5.8): jointly estimate one
affine per volume, consistent across all pairwise matches, instead of
chaining independent pairwise registrations.

Formulation: given edges (i, j) with matched point pairs (p, q) - p in
volume i, q in volume j, both in mm - find affines {A_i} minimizing

    sum_edges sum_k  | A_i [p_k; 1] - A_j [q_k; 1] |^2

with the gauge fixed by A_0 = I (volume 0 is the reference frame). Each
of the 3 output rows decouples, so the normal equations share one
(4(N-1), 4(N-1)) Gram matrix H with a (4(N-1), 3) right-hand side:

    H[ii] += sum hp hp^T        H[jj] += sum hq hq^T
    H[ij] -= sum hp hq^T        (h* = homogeneous points)
    edges touching volume 0 move their A_0 terms to the RHS.

Robustness: each edge is first filtered by the same RANSAC used for
pairwise registration; only inlier correspondences enter the solve.

Everything is float64. All edges are matched in one batched call, RANSAC
runs over the edges in chunks of at most ``RANSAC_CHUNK_BYTES`` of
temporaries (every edge keeps its own draws, so the chunking changes no
bit of the result), the Gram blocks are scattered into the reduced system
by ``index_put_(accumulate=True)`` (O(E + N^2); on the card its sorted
path adds each target's terms in edge order), and the dense system is
solved by ``torch.linalg.solve_ex``, whose non-zero ``info`` on a singular
system becomes non-finite affines and ``ok`` False, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..config import RANSAC_MIN_INLIERS, MatchParams, RansacParams
from ..dtypes import F64, resolve_device
from ..features.match import matches_to_coords, nn_match
from .pipeline import im2mm
from .ransac import find_tform_ransac

# Device memory that one chunk of edges may take in RANSAC temporaries,
# and the bytes a (edge, hypothesis, match row) entry takes at the peak of
# ``find_tform_ransac`` (its (B, H, M, 3) float64 residuals, their square
# and the (B, H, M) errors and masks; 81.6-82.1 measured on an H100).
# Each chunk costs about 2 ms of launches on top of its work: on the H100
# the 510 config-5 edges (M = 91, H = 1000) took 82.0 / 15.4 / 9.6 / 8.7 /
# 8.2 ms in chunks of 16 / 64 / 128 / 256 / 510 edges (peak 0.11-3.5 GiB),
# so a chunk may take 4 GiB.
RANSAC_CHUNK_BYTES = 4 << 30
RANSAC_ENTRY_BYTES = 82


@dataclasses.dataclass
class GroupwiseResult:
    A: torch.Tensor             # (N, 3, 4) f64: volume i -> frame 0
    edge_inliers: torch.Tensor  # (E,) i32 inliers per edge
    edge_ok: torch.Tensor       # (E,) bool - edge had >= 5 inliers
    ok: torch.Tensor            # () bool - system solvable & all edges usable


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                                    device=x.device)], dim=-1)


def _edge_blocks(src, ref, weights):
    """Per-edge Gram blocks (Gpp, Gqq, Gpq), each (..., 4, 4), with
    h = [pts; 1] of (..., M, 3) points and (..., M) weights.

    src plays p (volume i), ref plays q (volume j).
    """
    hp_u = _homogeneous(src.to(F64))
    hq_u = _homogeneous(ref.to(F64))
    w = weights.to(F64)[..., None]
    # Unweighted second factor keeps the blocks equal to sum_k w_k h h^T
    # for 0/1 weights.
    hpT = (hp_u * w).transpose(-1, -2)
    hqT = (hq_u * w).transpose(-1, -2)
    return hpT @ hp_u, hqT @ hq_u, hpT @ hq_u


def _accumulate_system(edges_ij, Gpp, Gqq, Gpq, w, num_volumes: int):
    """Scatter per-edge Gram blocks into the reduced normal-equation
    system: O(E + N^2) work and memory (no one-hot over the N^2 blocks).

    Args:
      edges_ij: (E, 2) int volume indices. w: (E,) 0/1 edge weights.
      Gpp/Gqq/Gpq: (E, 4, 4) per-edge blocks (already inlier-weighted).
    Returns (H4 (N-1, N-1, 4, 4), rhs4 (N-1, 4, 3)).
    """
    n1 = num_volumes - 1
    dev = Gpp.device
    e = torch.as_tensor(edges_ij, device=dev).long()
    i, j = e[:, 0], e[:, 1]
    ic = (i - 1).clamp(0, n1 - 1)        # masked rows carry zero data,
    jc = (j - 1).clamp(0, n1 - 1)        # so the clipped target is inert

    def seg(data, mask, ids, num):
        d = data * (w * mask.to(w.dtype))[:, None, None]
        return d.new_zeros((num,) + d.shape[1:]).index_put_(
            (ids,), d, accumulate=True)

    # Diagonal blocks: H[a, a] += Gpp (a = i-1) and += Gqq (a = j-1).
    diag = seg(Gpp, i > 0, ic, n1) + seg(Gqq, j > 0, jc, n1)
    # Cross blocks: H[i-1, j-1] -= Gpq and H[j-1, i-1] -= Gpq^T.
    cross = seg(-Gpq, (i > 0) & (j > 0), ic * n1 + jc,
                n1 * n1).reshape(n1, n1, 4, 4)
    H4 = cross + cross.permute(1, 0, 3, 2)
    a = torch.arange(n1, device=dev)
    H4[a, a] += diag
    # Gauge terms: edges touching volume 0 (A_0 = I) move to the RHS.
    GpqT = Gpq.transpose(-1, -2)
    rhs4 = (seg(GpqT[:, :, :3], (i == 0) & (j > 0), jc, n1) +
            seg(Gpq[:, :, :3], (j == 0) & (i > 0), ic, n1))
    return H4, rhs4


def _solve_reduced(H4, rhs4, num_volumes: int, ridge: float):
    """Dense solve of the reduced system; a singular system gives
    non-finite affines (``solve_ex`` reports it instead of raising)."""
    n_unk = 4 * (num_volumes - 1)
    eye = torch.eye(n_unk, dtype=F64, device=H4.device)
    H = H4.permute(0, 2, 1, 3).reshape(n_unk, n_unk) + ridge * eye
    X, info = torch.linalg.solve_ex(H, rhs4.reshape(n_unk, 3))
    X = torch.where(info == 0, X, torch.full_like(X, float("nan")))
    first = torch.eye(3, 4, dtype=F64, device=H4.device)[None]
    return torch.cat([first, X.reshape(num_volumes - 1, 4, 3)
                      .transpose(-1, -2)])


def _point_centroid(src_pts, ref_pts, counts):
    """Sum and number of all valid src+ref points: the centering offset
    for the normal equations (Hartley-style conditioning - raw mm
    coordinates ~O(100) square to an H with condition number ~1e6;
    centering makes the translation block near-orthogonal to the linear
    block). Returns (sum (3,), n ())."""
    M = src_pts.shape[1]
    valid = (torch.arange(M, device=src_pts.device) <
             counts[:, None]).to(F64)
    s = torch.einsum("em,emk->k", valid, src_pts.to(F64) + ref_pts.to(F64))
    return s, 2.0 * valid.sum()


def _uncenter(A, c):
    """Map the centered-frame solution back: y = L x + (t' + c - L c)."""
    L = A[:, :, :3]
    t = A[:, :, 3] + c[None, :] - torch.einsum("nij,j->ni", L, c)
    return torch.cat([L, t[:, :, None]], dim=-1)


def edge_chunk(params: RansacParams, rows: int) -> int:
    """Edges of ``rows`` padded match rows that one RANSAC chunk holds
    within ``RANSAC_CHUNK_BYTES``."""
    per_edge = params.num_iter * params.oversample * max(rows, 1) * \
        RANSAC_ENTRY_BYTES
    return max(1, RANSAC_CHUNK_BYTES // per_edge)


def _ransac_edges(src, ref, counts, params: RansacParams, idx=None,
                  chunk: int | None = None):
    """Per-edge RANSAC over (E, M, 3) points, ``chunk`` edges at a time
    (default: ``edge_chunk``). Returns the (E,) inlier counts and the
    (E, M) inlier masks."""
    E, M = src.shape[:2]
    if chunk is None:
        chunk = edge_chunk(params, M)
    n_in, masks = [], []
    for a in range(0, E, chunk):
        res = find_tform_ransac(src[a:a + chunk], ref[a:a + chunk],
                                counts[a:a + chunk], params,
                                idx=None if idx is None else idx[a:a + chunk])
        n_in.append(res.num_inliers)
        masks.append(res.inlier_mask)
    return torch.cat(n_in), torch.cat(masks)


def _check_edges(edges_ij) -> np.ndarray:
    e = np.asarray(edges_ij.cpu() if torch.is_tensor(edges_ij) else edges_ij)
    if (e[:, 0] == e[:, 1]).any():
        raise ValueError("self-edge in edges_ij")
    return e


def _solve_inliers(edges_ij, src, ref, counts, inlier, num_volumes: int,
                   ridge: float):
    """Affines (N, 3, 4) from the edges' inlier correspondences: centre,
    form the Gram blocks, accumulate the reduced system and solve it."""
    csum, cn = _point_centroid(src, ref, counts)
    c = csum / cn.clamp(min=1.0)
    Gpp, Gqq, Gpq = _edge_blocks(src - c, ref - c, inlier)
    H4, rhs4 = _accumulate_system(
        edges_ij, Gpp, Gqq, Gpq,
        torch.ones(len(edges_ij), dtype=F64, device=src.device), num_volumes)
    return _uncenter(_solve_reduced(H4, rhs4, num_volumes, ridge), c)


def groupwise_solve(edges_ij, src_pts, ref_pts, counts, num_volumes: int,
                    ransac_params: RansacParams = RansacParams(),
                    ridge: float = 1e-9, device=None,
                    ransac_idx: torch.Tensor | None = None
                    ) -> GroupwiseResult:
    """Solve for per-volume affines from per-edge padded correspondences.

    Args:
      edges_ij: (E, 2) int volume indices per edge.
      src_pts, ref_pts: (E, M, 3) padded matched points in mm (numpy or
        torch); row k of edge e pairs src_pts[e, k] (in volume
        edges_ij[e, 0]) with ref_pts[e, k] (in volume edges_ij[e, 1]).
      counts: (E,) number of valid correspondences per edge.
      num_volumes: N; volume 0 is the gauge (A_0 = I).
      device: where to solve; None means the card (and raises without
        one).
      ransac_idx: optional (E, H, 4) RANSAC hypothesis indices in place of
        the seeded draws.

    Returns GroupwiseResult with A[0] = I; nothing waits on the host.
    """
    edges = _check_edges(edges_ij)
    ransac_params.validate()
    dev = resolve_device(device)
    src = torch.as_tensor(src_pts).to(device=dev, dtype=F64)
    ref = torch.as_tensor(ref_pts).to(device=dev, dtype=F64)
    counts = torch.as_tensor(counts).to(dev).long()
    with record_function("sift3d.ransac"):
        n_in, inlier = _ransac_edges(src, ref, counts, ransac_params,
                                     ransac_idx)
    with record_function("sift3d.groupwise_solve"):
        A = _solve_inliers(edges, src, ref, counts, inlier, num_volumes,
                           ridge)
    edge_ok = n_in >= RANSAC_MIN_INLIERS
    return GroupwiseResult(A=A, edge_inliers=n_in.int(), edge_ok=edge_ok,
                           ok=edge_ok.all() & torch.isfinite(A).all())


def _match_edges(descriptors, edges_ij, units, match_params: MatchParams,
                 ssd_dtype=torch.float32):
    """All edges matched in one batched call on the descriptors' device,
    the SSD in ``ssd_dtype``. Returns (src, ref, cnt): (E, K, 3) f64
    matched points in mm and (E,) counts."""
    e = torch.as_tensor(edges_ij, device=descriptors.vec.device).long()
    i, j = e[:, 0], e[:, 1]
    valid = descriptors.valid_mask()
    m = nn_match(descriptors.vec[i], descriptors.vec[j],
                 match_params.nn_thresh, valid[i], valid[j], dtype=ssd_dtype)
    s, r, c = matches_to_coords(descriptors.xyz[i], descriptors.xyz[j], m)
    return im2mm(s, units), im2mm(r, units), c


def register_groupwise(descriptors, edges_ij, units,
                       match_params: MatchParams | None = None,
                       ransac_params: RansacParams = RansacParams(),
                       ssd_dtype=torch.float32,
                       ransac_idx: torch.Tensor | None = None
                       ) -> GroupwiseResult:
    """Groupwise registration from per-volume descriptor sets, on the
    device that holds them.

    Args:
      descriptors: Descriptors with a leading volume axis (N, K, ...) and
        (N,) counts, e.g. from ``parallel.pipeline.batch_detect_describe``
        or ``convert.descriptors_from_numpy``.
      edges_ij: (E, 2) int array of volume index pairs to match.
      units: shared (ux, uy, uz) of all volumes.
      ssd_dtype: the matcher's SSD precision (float32 by default, as in
        the JAX package; float64 as the reference accumulates).
      ransac_idx: optional (E, H, 4) RANSAC hypothesis indices.
    """
    if match_params is None:
        match_params = MatchParams()
    edges = _check_edges(edges_ij)
    with record_function("sift3d.match"):
        src, ref, cnt = _match_edges(descriptors, edges, units, match_params,
                                     ssd_dtype)
    return groupwise_solve(edges, src, ref, cnt,
                           num_volumes=int(descriptors.count.shape[0]),
                           ransac_params=ransac_params,
                           device=descriptors.vec.device,
                           ransac_idx=ransac_idx)


# --- over a mesh: the edges split over an axis ------------------------------

def _edge_slice(E: int, mesh, axis_name: str):
    """(first, end, per-rank) edges of this rank: the E edges padded to a
    multiple of the axis size, a contiguous block a rank."""
    per = -(-E // mesh.size(axis_name))
    lo = min(E, mesh.index(axis_name) * per)
    return lo, min(E, lo + per), per


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended up to n rows."""
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + t.shape[1:])])


def _solve_sharded(edges_l, src, ref, counts, idx, n_real: int,
                   num_volumes: int, mesh, axis_name: str,
                   ransac_params: RansacParams, ridge: float, E: int):
    """The shard_map body of ``groupwise_solve_sharded``: this rank's
    (per, M, 3) edge block, its first ``n_real`` rows real, the rest
    inactive (count 0)."""
    from ..parallel.mesh import all_gather, psum
    dev = src.device
    real = torch.arange(src.shape[0], device=dev) < n_real
    with record_function("sift3d.ransac"):
        n_in, inlier = _ransac_edges(src, ref, counts, ransac_params, idx)
    with record_function("sift3d.groupwise_solve"):
        w = real.to(F64)
        # The centring offset from the valid points of every rank.
        csum, cn = _point_centroid(src, ref, counts * real)
        c = psum(csum, mesh, axis_name) / \
            psum(cn[None], mesh, axis_name)[0].clamp(min=1.0)
        Gpp, Gqq, Gpq = _edge_blocks(src - c, ref - c,
                                     inlier.to(F64) * w[:, None])
        H4, rhs4 = _accumulate_system(edges_l, Gpp, Gqq, Gpq, w,
                                      num_volumes)
        A = _uncenter(_solve_reduced(psum(H4, mesh, axis_name),
                                     psum(rhs4, mesh, axis_name),
                                     num_volumes, ridge), c)
    # Every rank's edges in order: the padding is past the E real ones.
    n_in = all_gather(n_in, mesh, axis_name).reshape(-1)[:E]
    edge_ok = n_in >= RANSAC_MIN_INLIERS
    return GroupwiseResult(A=A, edge_inliers=n_in.int(), edge_ok=edge_ok,
                           ok=edge_ok.all() & torch.isfinite(A).all())


def groupwise_solve_sharded(edges_ij, src_pts, ref_pts, counts,
                            num_volumes: int, mesh, axis_name: str = "data",
                            ransac_params: RansacParams = RansacParams(),
                            ridge: float = 1e-9, device=None,
                            ransac_idx: torch.Tensor | None = None
                            ) -> GroupwiseResult:
    """Distributed ``groupwise_solve``: the edges split over ``axis_name``
    of ``mesh`` (``parallel.mesh.make_mesh``).

    Every rank takes the same global inputs (as ``groupwise_solve``) and
    uploads its block of edges: the E edges padded to a multiple of the
    axis size with inactive ones (count 0), a contiguous block a rank. A
    rank RANSAC-filters its edges and accumulates their Gram blocks into a
    partial reduced system in float64; an ``all_reduce`` sums the centring
    offset's terms and the partial (N-1, N-1, 4, 4) systems, and every rank
    solves. ``device``: None is the card (and raises without one); the
    mesh must be on the same kind of device. Returns the GroupwiseResult
    of all E edges on every rank.
    """
    from ..parallel.mesh import mesh_device
    edges = _check_edges(edges_ij)
    ransac_params.validate()
    dev = mesh_device(mesh, device)
    E = len(edges)
    lo, hi, per = _edge_slice(E, mesh, axis_name)

    def block(a, dtype):
        return _padded(torch.as_tensor(a[lo:hi]).to(device=dev, dtype=dtype),
                       per)
    idx = None if ransac_idx is None else block(ransac_idx, torch.long)
    return _solve_sharded(block(edges, torch.long), block(src_pts, F64),
                          block(ref_pts, F64), block(counts, torch.long), idx,
                          hi - lo, num_volumes, mesh, axis_name,
                          ransac_params, ridge, E)


def register_groupwise_sharded(descriptors, edges_ij, units, mesh,
                               axis_name: str = "data",
                               match_params: MatchParams | None = None,
                               ransac_params: RansacParams = RansacParams(),
                               ssd_dtype=torch.float32,
                               ransac_idx: torch.Tensor | None = None,
                               device=None) -> GroupwiseResult:
    """Distributed ``register_groupwise``: the edge work (matching, RANSAC,
    Gram accumulation) split over ``axis_name``, the descriptors the same
    on every rank, the reduced solve on every rank after an
    ``all_reduce`` (``groupwise_solve_sharded``).

    Args as ``register_groupwise`` plus the mesh; ``descriptors`` may lie
    anywhere (each rank uploads the set); ``device``: None is the card
    (and raises without one).
    """
    from ..parallel.mesh import mesh_device
    if match_params is None:
        match_params = MatchParams()
    edges = _check_edges(edges_ij)
    ransac_params.validate()
    dev = mesh_device(mesh, device)
    desc = dataclasses.replace(descriptors, **{
        f: getattr(descriptors, f).to(dev)
        for f in ("xyz", "sd", "vec", "count")})
    E = len(edges)
    lo, hi, per = _edge_slice(E, mesh, axis_name)
    K = desc.capacity
    with record_function("sift3d.match"):
        if hi > lo:
            src, ref, cnt = _match_edges(desc, edges[lo:hi], units,
                                         match_params, ssd_dtype)
        else:
            src = ref = torch.zeros((0, K, 3), dtype=F64, device=dev)
            cnt = torch.zeros(0, dtype=torch.long, device=dev)
    edges_l = torch.as_tensor(edges[lo:hi]).to(device=dev, dtype=torch.long)
    idx = None if ransac_idx is None else _padded(
        torch.as_tensor(ransac_idx[lo:hi]).to(device=dev, dtype=torch.long),
        per)
    return _solve_sharded(_padded(edges_l, per), _padded(src, per),
                          _padded(ref, per), _padded(cnt.long(), per), idx,
                          hi - lo, int(desc.count.shape[0]), mesh,
                          axis_name, ransac_params, 1e-9, E)
