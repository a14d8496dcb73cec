"""Icosahedral geometry for gradient-histogram binning.

The tables are numpy copies of ``sift3d_tpu/ops/geometry.py``: the same
regular icosahedron as the reference (12 vertices from golden-ratio
rectangles inscribed in the unit sphere, 20 triangular faces with
outward-corrected winding; reference sift3d/sift.c:215-326). Binning
picks the face hit by the ray along g as the argmax of g against the 20
outward unit normals (every face plane is equidistant from the centre),
with ties to the lowest face index like the reference's first-hit scan
(icos_hist_bin, sift.c:1646-1683).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import BARY_EPS, GOLDEN_RATIO, ICOS_NFACES, ICOS_NVERT


@functools.lru_cache(maxsize=1)
def icosahedron():
    """Returns (verts (12,3) f32 unit, geom (20,3) i32 winding-corrected
    vertex order for intersection, faces (20,3) i32 original order for
    bin accumulation; init_geometry, sift.c:224-323)."""
    gr = GOLDEN_RATIO
    verts = np.array([
        [0, 1, gr], [0, -1, gr], [0, 1, -gr], [0, -1, -gr],
        [1, gr, 0], [-1, gr, 0], [1, -gr, 0], [-1, -gr, 0],
        [gr, 0, 1], [-gr, 0, 1], [gr, 0, -1], [-gr, 0, -1]],
        dtype=np.float64)
    faces = np.array([
        [0, 1, 8], [0, 8, 4], [0, 4, 5], [0, 5, 9], [0, 9, 1],
        [1, 6, 8], [8, 6, 10], [8, 10, 4], [4, 10, 2], [4, 2, 5],
        [5, 2, 11], [5, 11, 9], [9, 11, 7], [9, 7, 1], [1, 7, 6],
        [3, 6, 7], [3, 7, 11], [3, 11, 2], [3, 2, 10], [3, 10, 6]],
        dtype=np.int32)
    # Normalize each vertex with float32 arithmetic, as the reference does
    # (CVEC_L2_NORM / CVEC_SCALE are float, sift.c:292-295).
    v32 = verts.astype(np.float32)
    norms = np.sqrt((v32 * v32).sum(-1, dtype=np.float32)).astype(np.float32)
    v32 = (v32 * (np.float32(1.0) / norms)[:, None]).astype(np.float32)

    # The reference swaps the first two vertex *positions* when the normal
    # faces inward (sift.c:298-314) but leaves tri->idx untouched, so
    # barycentric weight j always goes to bin faces[i][j] of the ORIGINAL
    # ordering (MESH_HIST_GET, sift.c:61-66).
    geom = faces.copy()
    for i in range(ICOS_NFACES):
        tri = v32[geom[i]]
        n = np.cross(tri[2] - tri[1], tri[1] - tri[0])
        if np.dot(n, tri[0]) < 0:
            geom[i, 0], geom[i, 1] = geom[i, 1], geom[i, 0]
    return v32, geom, faces


@functools.lru_cache(maxsize=1)
def face_tables():
    """Static per-face arrays (float32 unless noted):
      v0, e1, e2: (20, 3) triangle vertex and edges (winding-corrected)
      q: (20, 3) cross(-v0, e1)
      idx: (20, 3) int32 vertex indices for bin accumulation (original order)
      onehot: (20, 3, 12) one-hot of idx
    """
    verts, geom, faces = icosahedron()
    tri = verts[geom]                        # (20, 3, 3)
    v0 = tri[:, 0]
    e1 = (tri[:, 1] - tri[:, 0]).astype(np.float32)
    e2 = (tri[:, 2] - tri[:, 0]).astype(np.float32)
    q = np.cross(-v0, e1).astype(np.float32)
    onehot = np.zeros((ICOS_NFACES, 3, ICOS_NVERT), np.float32)
    for f in range(ICOS_NFACES):
        for j in range(3):
            onehot[f, j, faces[f, j]] = 1.0
    return dict(v0=v0, e1=e1, e2=e2, q=q, idx=faces, onehot=onehot)


@functools.lru_cache(maxsize=1)
def face_solve_tables():
    """Closed-form intersection tables: (normals (20, 3) f32 unit outward,
    vinv (20, 9) f32 row-major inverses of the vertex matrices). The
    barycentric coordinates of the ray along g on face f are
    vinv[f] @ g divided by their sum."""
    verts, geom, _ = icosahedron()
    tri = verts[geom].astype(np.float64)                # (20, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(axis=1)
    n *= np.sign(np.sum(n * centroid, axis=1, keepdims=True))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    vmat = np.transpose(tri, (0, 2, 1))                  # columns = vertices
    vinv = np.linalg.inv(vmat).reshape(ICOS_NFACES, 9)
    return n.astype(np.float32), vinv.astype(np.float32)


def icos_hist_bin(grad: torch.Tensor):
    """Icosahedral binning of gradient vectors (..., 3) float32.

    Returns face (...,) int64, bary (..., 3) float32 barycentric
    coordinates on that face, ok (...,) bool (large enough and hits a face).
    """
    normals, vinv = face_solve_tables()
    dev = grad.device
    scores = torch.matmul(grad, torch.as_tensor(normals, device=dev).T)
    face = torch.argmax(scores, dim=-1)       # first max: lowest face index
    B = torch.as_tensor(vinv, device=dev)[face].reshape(face.shape + (3, 3))
    raw = torch.matmul(B, grad[..., None])[..., 0]           # V^-1 g
    s = torch.sum(raw, dim=-1)
    s_ok = s > 0
    bary = raw / torch.where(s_ok, s, torch.ones_like(s))[..., None]
    mag_ok = torch.sum(grad * grad, -1) >= BARY_EPS
    return face, bary, s_ok & mag_ok


def vertex_weights(face: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """(..., 12) per-vertex weights: bary[j] accumulated into bin
    faces[face][j] (MESH_HIST_GET, sift.c:61-66)."""
    idx = torch.as_tensor(face_tables()["idx"], device=face.device).long()
    out = torch.zeros(face.shape + (ICOS_NVERT,), dtype=bary.dtype,
                      device=bary.device)
    return out.scatter_add_(-1, idx[face], bary)
