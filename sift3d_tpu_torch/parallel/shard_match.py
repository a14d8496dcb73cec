"""Sharded descriptor matching.

The port of ``sift3d_tpu/parallel/shard_match.py``. For descriptor sets
too large for one device, d2 is split over a mesh axis: each rank reduces
its (N1, N2/S) distance block to per-query top-2 (value, index) triples,
and the triples of all ranks meet in an ``all_gather``. The backward
(d2 -> d1) reduction runs on each rank's own d2 rows and is gathered once.

The local reduction of ``nn_match_sharded`` is the streamed matcher
(``ops/cuda_match.match_reduce_streamed``: kernel 2 on the card, one
launch per direction) once the local block reaches
``MatchParams.streamed_threshold`` entries on a CUDA tensor, or when asked
(``streamed=True``); otherwise a dense ``ssd_matrix`` block in ``dtype``.
The ring (``nn_match_ring``) keeps JAX's dense block per step, in
``dtype``. Both take ``dtype`` at JAX's position and name; the streamed
reduction ignores it, as JAX's does (kernel 2 is fp32).

Cross-rank merges keep JAX's tie rule (``top_k`` takes the lower position
on ties): the winner is the first rank, in coordinate order, whose best
equals the global best, so match indices equal the single-device
matcher's wherever no exact SSD tie spans two ranks.
"""

from __future__ import annotations

import torch

from ..config import MatchParams
from ..features.match import _ratio_accept, _top2_min, ssd_matrix
from ..ops.cuda_match import match_reduce_streamed
from .mesh import Mesh, all_gather, ring_shift


def _second_of(*vals: torch.Tensor) -> torch.Tensor:
    """The second-smallest of the stacked candidates, per column."""
    return torch.topk(torch.cat(vals, 0), 2, dim=0, largest=False).values[1]


def _dense_top2(d1, d2, v1, v2, dtype):
    """Both directions' (idx, best, second) of a dense SSD block in
    ``dtype`` with the invalid rows and columns at +inf."""
    inf = float("inf")
    D = ssd_matrix(d1, d2, dtype)
    D = torch.where(v2[None, :], D, inf)
    D = torch.where(v1[:, None], D, inf)
    return _top2_min(D), _top2_min(D.T)


def nn_match_sharded(d1: torch.Tensor, d2: torch.Tensor, nn_thresh: float,
                     mesh: Mesh, axis_name: str = "space",
                     valid1: torch.Tensor | None = None,
                     valid2: torch.Tensor | None = None,
                     dtype=torch.float32, streamed: bool | None = None,
                     streamed_threshold: int | None = None) -> torch.Tensor:
    """Match d1 (replicated) against d2 (its rows split over the axis).

    Args:
      d1: (N1, 768), the same on every rank; d2: this rank's (N2/S, 768)
        block of rows. valid1 / valid2: row-validity masks of the same
        blocks.
      dtype: the dense block's SSD precision (and its ratio test's);
        ignored by the streamed reduction, which is fp32.
      streamed: run the local top-2 as the streamed reduction (kernel 2
        on the card). None: on a CUDA tensor once N1 * N2/S reaches
        ``streamed_threshold`` (``MatchParams().streamed_threshold``).

    Returns (N1,) int32 matches into the whole d2 (-1 = none), the same on
    every rank of the axis.
    """
    n1, n2_loc = d1.shape[0], d2.shape[0]
    s = mesh.index(axis_name)
    dev = d1.device
    if valid1 is None:
        valid1 = torch.ones(n1, dtype=torch.bool, device=dev)
    if valid2 is None:
        valid2 = torch.ones(n2_loc, dtype=torch.bool, device=dev)
    if streamed is None:
        if streamed_threshold is None:
            streamed_threshold = MatchParams().streamed_threshold
        streamed = dev.type == "cuda" and n1 * n2_loc >= streamed_threshold
    if streamed:
        fbest, fsecond, fidx, bbest, bsecond, bidx = match_reduce_streamed(
            d1, d2, valid1=valid1, valid2=valid2)
    else:
        (fidx, fbest, fsecond), (bidx, bbest, bsecond) = _dense_top2(
            d1, d2, valid1, valid2, dtype)
    # Global d2 indices of the local forward winners; gather (S, N1).
    g_best = all_gather(fbest, mesh, axis_name)
    g_second = all_gather(fsecond, mesh, axis_name)
    g_idx = all_gather(fidx.long() + s * n2_loc, mesh, axis_name)
    pos = torch.argmin(g_best, dim=0, keepdim=True)     # first on ties
    best = torch.gather(g_best, 0, pos)[0]
    best_idx = torch.gather(g_idx, 0, pos)[0]
    second = _second_of(g_best, g_second)
    fwd_ok = _ratio_accept(best, second, nn_thresh)

    # Backward direction: this rank's d2 rows against all of d1.
    bwd_idx = all_gather(bidx.long(), mesh, axis_name).reshape(-1)
    bwd_ok = all_gather(_ratio_accept(bbest, bsecond, nn_thresh), mesh,
                        axis_name).reshape(-1)
    consistent = (bwd_idx[best_idx] == torch.arange(n1, device=dev)) & \
        bwd_ok[best_idx]
    any_v2 = all_gather(valid2.any()[None], mesh, axis_name).any()
    ok = fwd_ok & consistent & valid1 & any_v2
    return torch.where(ok, best_idx, -1).to(torch.int32)


def _merge_top2(best, second, idx, nb, ns, ni):
    """Merge two per-row (best, second, idx) candidate sets; an exact tie
    keeps the running entry (JAX's lower position)."""
    take = nb < best
    return (torch.where(take, nb, best),
            _second_of(best[None], second[None], nb[None], ns[None]),
            torch.where(take, ni, idx))


def nn_match_ring(d1: torch.Tensor, d2: torch.Tensor, nn_thresh: float,
                  mesh: Mesh, axis_name: str = "space",
                  valid1: torch.Tensor | None = None,
                  valid2: torch.Tensor | None = None,
                  dtype=torch.float32) -> torch.Tensor:
    """Fully-sharded matching: BOTH sets split over the axis; d2 blocks
    move around the ring (``ring_shift``) so that no rank holds more than
    (N1 + N2)/S descriptor rows.

    Each ring step computes one (N1/S, N2/S) distance block, folds it into
    the local d1 rows' running forward top-2 (global d2 indices), and folds
    the transposed reduction into a backward top-2 state that travels with
    the d2 block; after S steps every block and its state are home. The
    backward state is gathered once for the forward-backward check
    (sift.c:2881-2884).

    Args:
      d1, d2: this rank's (N1/S, 768) and (N2/S, 768) blocks; valid1 /
        valid2 their row masks.
      dtype: the SSD's precision, and that of the running top-2 states.
    Returns (N1,) int32 matches (the same on every rank of the axis).
    """
    n1_loc, n2_loc = d1.shape[0], d2.shape[0]
    n_sh = mesh.size(axis_name)
    s = mesh.index(axis_name)
    dev = d1.device
    if valid1 is None:
        valid1 = torch.ones(n1_loc, dtype=torch.bool, device=dev)
    if valid2 is None:
        valid2 = torch.ones(n2_loc, dtype=torch.bool, device=dev)
    inf = float("inf")
    fwd = (torch.full((n1_loc,), inf, dtype=dtype, device=dev),
           torch.full((n1_loc,), inf, dtype=dtype, device=dev),
           torch.zeros(n1_loc, dtype=torch.long, device=dev))
    bwd = (torch.full((n2_loc,), inf, dtype=dtype, device=dev),
           torch.full((n2_loc,), inf, dtype=dtype, device=dev),
           torch.zeros(n2_loc, dtype=torch.long, device=dev))
    blk, vblk = d2, valid2
    for t in range(n_sh):
        origin = (s - t) % n_sh              # the rank that owns this block
        (li, lb, ls), (ti, tb, ts) = _dense_top2(d1, blk, valid1, vblk,
                                                 dtype)
        fwd = _merge_top2(*fwd, lb, ls, li + origin * n2_loc)
        bwd = _merge_top2(*bwd, tb, ts, ti + s * n1_loc)
        # The d2 block and its accumulated backward state move on.
        blk, vblk, *bwd = ring_shift([blk, vblk, *bwd], mesh, axis_name)
    fb, fs, fi = fwd
    bb, bs, bi = bwd
    bwd_idx = all_gather(bi, mesh, axis_name).reshape(-1)
    bwd_ok = all_gather(_ratio_accept(bb, bs, nn_thresh), mesh,
                        axis_name).reshape(-1)
    rows = s * n1_loc + torch.arange(n1_loc, device=dev)
    consistent = (bwd_idx[fi] == rows) & bwd_ok[fi]
    any_v2 = all_gather(valid2.any()[None], mesh, axis_name).any()
    ok = _ratio_accept(fb, fs, nn_thresh) & consistent & valid1 & any_v2
    out = torch.where(ok, fi, -1).to(torch.int32)
    return all_gather(out, mesh, axis_name).reshape(-1)
