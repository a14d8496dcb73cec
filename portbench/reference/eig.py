"""Batched closed-form symmetric 3x3 eigendecomposition.

The port of ``sift3d_tpu/ops/eig.py``, which replaces the reference's
LAPACK dsyevd call (imutil.c:2992-3075) for the orientation structure
tensor. The trigonometric method gives eigenvalues in ascending order like
dsyevd; eigenvectors are the cross-product of the two best-conditioned
rows of (A - lambda I).
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def eigh3x3(A: torch.Tensor):
    """Eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (lam, Q): lam (..., 3) ascending, Q (..., 3, 3) with
    orthonormal eigenvector columns Q[..., :, i].
    """
    dtype = A.dtype
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q; b11 = a11 - q; b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    safe_p = torch.where(p > 0, p, torch.ones_like(p))

    # det((A - qI) / p) / 2
    c00 = b00 / safe_p; c01 = a01 / safe_p; c02 = a02 / safe_p
    c11 = b11 / safe_p; c12 = a12 / safe_p; c22 = b22 / safe_p
    detb = (c00 * (c11 * c22 - c12 * c12)
            - c01 * (c01 * c22 - c12 * c02)
            + c02 * (c01 * c12 - c11 * c02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    two_pi_3 = 2.0943951023931953
    lam2 = q + 2.0 * p * torch.cos(phi)               # largest
    lam0 = q + 2.0 * p * torch.cos(phi + two_pi_3)    # smallest
    lam1 = 3.0 * q - lam2 - lam0
    degenerate = p2 <= 0
    lam0 = torch.where(degenerate, q, lam0)
    lam1 = torch.where(degenerate, q, lam1)
    lam2 = torch.where(degenerate, q, lam2)
    lam = torch.stack([lam0, lam1, lam2], dim=-1)

    rows = torch.stack([
        torch.stack([a00, a01, a02], -1),
        torch.stack([a01, a11, a12], -1),
        torch.stack([a02, a12, a22], -1)], -2)        # (..., 3, 3)
    eye = torch.eye(3, dtype=dtype, device=A.device)

    def eigvec(lmbda):
        M = rows - lmbda[..., None, None] * eye       # rows of (A - lambda I)
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01_ = _cross(r0, r1)
        c02_ = _cross(r0, r2)
        c12_ = _cross(r1, r2)
        n01 = torch.sum(c01_ * c01_, -1)
        n02 = torch.sum(c02_ * c02_, -1)
        n12 = torch.sum(c12_ * c12_, -1)
        best = torch.argmax(torch.stack([n01, n02, n12], -1), dim=-1)
        v = torch.where((best == 0)[..., None], c01_,
                        torch.where((best == 1)[..., None], c02_, c12_))
        nrm = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
        return torch.where(nrm > 0,
                           v / torch.where(nrm > 0, nrm, torch.ones_like(nrm)),
                           torch.zeros_like(v))

    v0 = eigvec(lam0)
    v2 = eigvec(lam2)
    # Middle eigenvector: orthogonal complement - numerically cleanest.
    v1 = _cross(v2, v0)
    n1 = torch.sqrt(torch.sum(v1 * v1, -1, keepdim=True))
    v1 = torch.where(n1 > 0, v1 / torch.where(n1 > 0, n1, torch.ones_like(n1)),
                     v1)

    # Degenerate fallback (all eigenvalues equal): identity basis. These
    # tensors are rejected by the eigenvalue-ratio test downstream.
    Q = torch.stack([v0, v1, v2], dim=-1)
    Q = torch.where(degenerate[..., None, None], eye.expand_as(Q), Q)
    return lam, Q
