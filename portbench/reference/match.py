"""Nearest-neighbor descriptor matching.

Reproduces SIFT3D_nn_match / match_desc (reference sift3d/sift.c:2840-2969),
as ``sift3d_tpu/features/match.py`` does:

- brute-force SSD over all 768-dim descriptor pairs;
- ratio test: a query's match is rejected when
  ``ssd_best / ssd_second > nn_thresh**2`` (sift.c:2952-2954);
- forward-backward consistency: query i matches target j only if target j's
  best match among the queries is i and also passes the ratio test
  (sift.c:2881-2884).

The dense form is one SSD matrix ``|a|^2 + |b|^2 - 2 a.b`` (an fp32
``torch.matmul``) followed by two top-2 reductions. Ties resolve to the
lowest index (``torch.argmin`` returns the first minimum), like the strict
``<`` of the C scan. Sets may carry a leading batch axis: B pairs are then
one batched product on padded (B, K, 768) sets, as ``jax.vmap`` of the
dense matcher is in the JAX package. The streamed form, for large sets, is
``ops/cuda_match.nn_match_streamed``.
"""

from __future__ import annotations

import torch

from .config import F64


def _top2_min(D: torch.Tensor):
    """(argmin, min, second-min) along the last axis; second = +inf if
    size 1."""
    best_idx = torch.argmin(D, dim=-1)
    vals = torch.topk(D, min(2, D.shape[-1]), dim=-1, largest=False).values
    best = vals[..., 0]
    if D.shape[-1] >= 2:
        second = vals[..., 1]
    else:
        second = torch.full_like(best, float("inf"))
    return best_idx, best, second


def ssd_matrix(d1: torch.Tensor, d2: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Pairwise SSD matrix (..., N1, N2) via |a|^2+|b|^2-2ab, clamped at 0.

    The reference accumulates in float64 (sift.c:2925-2931); pass
    ``dtype=torch.float64`` for parity testing, float32 for the fast path.
    """
    a = d1.to(dtype)
    b = d2.to(dtype)
    g = torch.matmul(a, b.transpose(-1, -2))
    n1 = torch.sum(a * a, dim=-1)
    n2 = torch.sum(b * b, dim=-1)
    d = n1[..., :, None] + n2[..., None, :] - 2.0 * g
    return torch.clamp(d, min=0)


def _ratio_accept(best: torch.Tensor, second: torch.Tensor,
                  nn_thresh: float) -> torch.Tensor:
    # Reject iff best/second > t^2. Multiplicative form preserves the C
    # edge cases: second == 0 -> 0 > 0 false -> accept (C gets nan ratio,
    # nan > t^2 false); second == inf -> best > inf false -> accept.
    t2 = torch.as_tensor(nn_thresh, dtype=best.dtype) ** 2
    return ~(best > t2 * second)


def _consistent(fwd_idx, fwd_ok, bwd_idx, bwd_ok):
    """Forward/backward check: query i keeps target fwd_idx[i] only if that
    target's best query is i and it passes its own ratio test."""
    n1 = fwd_idx.shape[-1]
    ar = torch.arange(n1, device=fwd_idx.device)
    return fwd_ok & (torch.gather(bwd_idx, -1, fwd_idx) == ar) & \
        torch.gather(bwd_ok, -1, fwd_idx)


def nn_match(d1: torch.Tensor, d2: torch.Tensor, nn_thresh: float,
             valid1: torch.Tensor | None = None,
             valid2: torch.Tensor | None = None,
             dtype=torch.float32) -> torch.Tensor:
    """Match descriptors d1 (..., N1, 768) against d2 (..., N2, 768).

    Returns (..., N1) int32: index into d2 per d1 row, or -1. ``valid1`` /
    ``valid2`` (..., N1) / (..., N2) mark real (non-padding) rows;
    ``dtype`` is the SSD's precision (``ssd_matrix``), and the ratio test
    runs in it too.
    """
    if d1.shape[-2] == 0 or d2.shape[-2] == 0:
        return torch.full(d1.shape[:-1], -1, dtype=torch.int32,
                          device=d1.device)
    D = ssd_matrix(d1, d2, dtype)
    inf = float("inf")
    if valid2 is not None:
        D = torch.where(valid2[..., None, :], D, inf)
    if valid1 is not None:
        D = torch.where(valid1[..., :, None], D, inf)

    fwd_idx, fwd_best, fwd_second = _top2_min(D)
    bwd_idx, bwd_best, bwd_second = _top2_min(D.transpose(-1, -2))
    ok = _consistent(fwd_idx, _ratio_accept(fwd_best, fwd_second, nn_thresh),
                     bwd_idx, _ratio_accept(bwd_best, bwd_second, nn_thresh))
    if valid1 is not None:
        ok = ok & valid1
    if valid2 is not None:
        # No real target -> every row of D is +inf; guard the degenerate case.
        ok = ok & torch.any(valid2, -1, keepdim=True)
    return torch.where(ok, fwd_idx, -1).to(torch.int32)


def matches_to_coords(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      matches: torch.Tensor):
    """Compacted match coordinate pairs (SIFT3D_matches_to_Mat_rm,
    sift.c:2784-2826), per pair of a batch when the inputs carry a leading
    batch axis.

    Returns (src_xyz, ref_xyz, count): (..., N1, 3) f64 padded coordinate
    matrices in d1 row order (rows >= count are zero), and the match count
    as a (...) tensor. No host sync.
    """
    n1 = matches.shape[-1]
    sel = matches >= 0
    count = sel.sum(-1)
    # Matched rows go to their rank among the matches, the rest to a
    # dropped slot n1.
    dest = torch.where(sel, torch.cumsum(sel, -1) - 1, n1)[..., None]
    dest = dest.expand(dest.shape[:-1] + (3,))
    ref_rows = torch.gather(xyz2.to(F64), -2, matches.clamp(min=0).long()[
        ..., None].expand(dest.shape))
    shape = matches.shape[:-1] + (n1 + 1, 3)
    src = torch.zeros(shape, dtype=F64, device=xyz1.device).scatter_(
        -2, dest, xyz1.to(F64))
    ref = torch.zeros(shape, dtype=F64, device=xyz1.device).scatter_(
        -2, dest, ref_rows)
    return src[..., :n1, :], ref[..., :n1, :], count
