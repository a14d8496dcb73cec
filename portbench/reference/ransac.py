"""Vectorized RANSAC affine fitting, in float64.

Reproduces find_tform_ransac / ransac / solve_system (reference
imutil/imutil.c:4619-4882, 4490-4572), as ``sift3d_tpu/register/ransac.py``
does:

- the affine A (3x4) maps *ref* points to *src* points: the fitted system is
  ``[ref | 1] @ X = src`` with ``A = X^T``;
- each hypothesis draws 4 correspondences and solves the square system
  exactly; a draw is "singular" when the 1-norm reciprocal condition falls
  below 100*DBL_EPSILON (imutil.c:3089-3195);
- consensus = points with squared error <= err_thresh^2;
- the best (strictly larger, first-wins) consensus set over num_iter
  non-singular iterations is refined by least squares, keeping the
  unrefined transform if refinement is singular; at least 5 inliers are
  required (imutil.c:4787).

Hypotheses are drawn with replacement from a CPU ``torch.Generator``
seeded by ``RansacParams.seed`` (so the card and the CPU draw the same
indices); a duplicate index makes the system singular and is filtered.
``idx`` injects draws instead, which lets a test replay the JAX package's
own ``jax.random`` draws.

B pairs are fitted at once when the points carry a leading batch axis:
every pair scales the same uniform draws by its own count, as the vmapped
JAX function does, and nothing waits on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import F64, RANSAC_MIN_INLIERS, SINGULAR_RCOND, RansacParams


@dataclasses.dataclass
class RansacResult:
    """For one pair; a batch has a leading B axis on every field, and its
    counts and flags are (B,) tensors."""
    A: torch.Tensor            # (3, 4) affine, ref -> src
    num_inliers: int
    inlier_mask: torch.Tensor  # (N,) bool over the padded match rows
    ok: bool                   # >= 5 inliers found
    effective_iters: int       # non-singular hypotheses actually run


def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """[pts | 1] (..., n, 4)."""
    return torch.cat([pts, torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                                      device=pts.device)], dim=-1)


def _rcond_1norm(M: torch.Tensor) -> torch.Tensor:
    """Exact 1-norm reciprocal condition number of batched square
    matrices; 0 where the matrix is exactly singular."""
    norm1 = torch.amax(torch.sum(torch.abs(M), dim=-2), dim=-1)
    inv, info = torch.linalg.inv_ex(M)
    inv_norm1 = torch.amax(torch.sum(torch.abs(inv), dim=-2), dim=-1)
    r = 1.0 / (norm1 * inv_norm1)
    return torch.where(torch.isfinite(r) & (info == 0), r,
                       torch.zeros_like(r))


def _solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(M, rhs)[0]


def fit_affine_exact(src4: torch.Tensor, ref4: torch.Tensor):
    """Exact affine from 4 correspondences. Returns (A (...,3,4), rcond)."""
    B = _homogeneous(ref4)                       # (..., 4, 4)
    rcond = _rcond_1norm(B)
    eye = torch.eye(4, dtype=B.dtype, device=B.device)
    safe = torch.where((rcond > 0)[..., None, None], B, eye)
    X = _solve(safe, src4)                       # (..., 4, 3)
    return X.transpose(-1, -2), rcond


def fit_affine_ls(src: torch.Tensor, ref: torch.Tensor,
                  weights: torch.Tensor):
    """Weighted least-squares affine (solve_Mat_rm_ls, imutil.c:3207-3294)
    of (..., N, 3) points. Zero-weight rows drop out of the normal
    equations. Returns (A (..., 3, 4), ok (...) bool tensor)."""
    B = _homogeneous(ref.to(F64))                # (..., N, 4)
    Bw = B * weights.to(F64)[..., None]
    G = B.transpose(-1, -2) @ Bw
    rhs = Bw.transpose(-1, -2) @ src.to(F64)
    rcond = _rcond_1norm(G)
    ok = rcond > SINGULAR_RCOND ** 2             # G squares the conditioning
    eye = torch.eye(4, dtype=G.dtype, device=G.device)
    safe = torch.where(ok[..., None, None], G, eye)
    A = _solve(safe, rhs).transpose(-1, -2)
    return A, ok & torch.isfinite(A).flatten(-2).all(-1)


def draw_indices(count, params: RansacParams, device=None) -> torch.Tensor:
    """(..., num_iter * oversample, 4) hypothesis indices, uniform over the
    first ``count`` rows, with replacement: one set of uniform draws,
    scaled by each pair's count (an int, or a (B,) tensor)."""
    n_hyp = params.num_iter * params.oversample
    gen = torch.Generator(device="cpu").manual_seed(params.seed)
    u = torch.rand((n_hyp, 4), generator=gen, dtype=F64).to(device)
    count = torch.as_tensor(count, device=device)[..., None, None]
    return torch.minimum((u * count).long(), (count - 1).clamp(min=0))


def find_tform_ransac(src: torch.Tensor, ref: torch.Tensor, count,
                      params: RansacParams = RansacParams(),
                      idx: torch.Tensor | None = None) -> RansacResult:
    """RANSAC affine fit on padded correspondence arrays.

    Args:
      src, ref: (N, 3) padded point matrices (same physical units), or
        (B, N, 3) for B pairs; rows >= count are padding.
      count: number of valid correspondences: an int, or a (B,) tensor.
      params: RansacParams.
      idx: optional (num_iter * oversample, 4) hypothesis indices, or
        (B, num_iter * oversample, 4), in place of the seeded draws.

    Returns RansacResult (batched for batched points); A maps ref -> src
    like the reference.
    """
    single = src.ndim == 2
    src = src.to(F64)
    ref = ref.to(F64)
    if single:
        src, ref = src[None], ref[None]
    dev = src.device
    n_pairs, n_cap = src.shape[:2]
    if n_cap == 0:
        # No rows at all: one padding row keeps the draws' gather in range.
        src = ref = torch.zeros((n_pairs, 1, 3), dtype=F64, device=dev)
        n_cap = 1
    count = torch.as_tensor(count, device=dev).reshape(n_pairs)
    if idx is None:
        idx = draw_indices(count, params, dev)
    idx = idx.to(device=dev, dtype=torch.long).reshape(n_pairs, -1, 4)

    pair = torch.arange(n_pairs, device=dev)
    A_h, rcond = fit_affine_exact(src[pair[:, None, None], idx],
                                  ref[pair[:, None, None], idx])  # (B,H,3,4)
    nonsingular = (rcond > SINGULAR_RCOND) & \
        torch.isfinite(A_h).flatten(-2).all(-1)

    # Keep only the first num_iter non-singular hypotheses, emulating the
    # reference's retry-until-nonsingular loop.
    rank = torch.cumsum(nonsingular.long(), -1) - 1
    active = nonsingular & (rank < params.num_iter)

    valid_pt = torch.arange(n_cap, device=dev) < count[:, None]
    out = torch.einsum("bhij,bnj->bhni", A_h[..., :3], ref) + \
        A_h[..., None, :, 3]
    d = src[:, None] - out
    err2 = torch.sum(d * d, dim=-1)
    inliers = (err2 <= float(params.err_thresh) ** 2) & valid_pt[:, None, :]
    counts = torch.where(active, torch.sum(inliers, dim=-1),
                         torch.full_like(active, -1, dtype=torch.long))

    best = torch.argmax(counts, -1)              # first max (strict > in C)
    best_mask = inliers[pair, best]
    A_ref, ref_ok = fit_affine_ls(src, ref, best_mask.to(F64))
    A_final = torch.where(ref_ok[:, None, None], A_ref, A_h[pair, best])
    len_best = counts[pair, best]
    res = RansacResult(A=A_final, num_inliers=len_best, inlier_mask=best_mask,
                       ok=len_best >= RANSAC_MIN_INLIERS,
                       effective_iters=active.sum(-1))
    if not single:
        return res
    n_in, it = torch.stack([len_best[0], res.effective_iters[0]]).tolist()
    return RansacResult(A=A_final[0], num_inliers=n_in,
                        inlier_mask=best_mask[0],
                        ok=n_in >= RANSAC_MIN_INLIERS, effective_iters=it)
