"""Host-side drawing utilities (numpy).

Reproduce draw_grid / draw_points / draw_lines (reference
imutil/imutil.c:973-1163) and draw_matches (sift3d/sift.c:2990-3128).
These are small visualization helpers on the IO path, so they stay host
code, like CSV writing.

Arrays are (nz, ny, nx) float32; point matrices are (N, 3) in (x, y, z)
column order like the reference's Mat_rm coordinates.
"""

from __future__ import annotations

import numpy as np


def draw_grid(dims_xyz, spacing: int, line_width: int = 1) -> np.ndarray:
    """Grid image (imutil.c:973-1009): voxels within line_half_width of a
    plane x|y|z = k*spacing are set to 1."""
    if spacing < 2 or line_width < 1 or line_width > spacing:
        raise ValueError("invalid spacing/line_width")
    nx, ny, nz = dims_xyz
    half = line_width / 2.0
    out = np.zeros((nz, ny, nx), np.float32)
    # A voxel p is lit iff some grid voxel g (on a spacing plane) has
    # |p - g| < half in all dims; with integer coords this reduces to
    # distance-to-nearest-plane < half per the drawing loop.
    for n, axis in ((nx, 2), (ny, 1), (nz, 0)):
        coords = np.arange(n)
        dist = np.minimum(coords % spacing, spacing - (coords % spacing))
        near = dist < half
        # The center voxel on the plane itself is always lit (x % spacing
        # == 0 case with x_draw == x).
        near = near | (coords % spacing == 0)
        shape = [1, 1, 1]
        shape[axis] = n
        out = np.maximum(out, near.reshape(shape).astype(np.float32))
    return out


def draw_points(points_xyz: np.ndarray, dims_xyz, radius: int = 1
                ) -> np.ndarray:
    """Cubes of half-width ``radius`` at each point (imutil.c:1012-1059)."""
    nx, ny, nz = dims_xyz
    out = np.zeros((nz, ny, nx), np.float32)
    pts = np.asarray(points_xyz).astype(np.int32)  # C int conversion truncates
    for cx, cy, cz in pts[:, :3]:
        xs, xe = max(cx - radius, 0), min(cx + radius, nx - 1)
        ys, ye = max(cy - radius, 0), min(cy + radius, ny - 1)
        zs, ze = max(cz - radius, 0), min(cz + radius, nz - 1)
        if xe >= xs and ye >= ys and ze >= zs:
            out[zs:ze + 1, ys:ye + 1, xs:xe + 1] = 1.0
    return out


def draw_lines(points1_xyz: np.ndarray, points2_xyz: np.ndarray, dims_xyz
               ) -> np.ndarray:
    """XY-plane line rasterizer (imutil.c:1063-1163), line_step = 0.1."""
    p1 = np.asarray(points1_xyz, np.float64)
    p2 = np.asarray(points2_xyz, np.float64)
    if p1.shape != p2.shape or p1.shape[1] != 3:
        raise ValueError("point matrices must both be (N, 3)")
    nx, ny, nz = dims_xyz
    out = np.zeros((nz, ny, nx), np.float32)
    step = 0.1
    for (p1x, p1y, p1z), (p2x, p2y, p2z) in zip(p1, p2):
        if not (0 <= p1x < nx and 0 <= p1y < ny and 0 <= p1z < nz and
                0 <= p2x < nx and 0 <= p2y < ny and 0 <= p2z < nz):
            continue
        x_start = min(p1x, p2x) + 0.5
        x_end = max(p1x, p2x) + 0.5
        zi = int(p1z)
        if abs(x_start - x_end) < 1.0:     # vertical line
            xi = int(x_start)
            for y in range(int(min(p1y, p2y)), int(max(p1y, p2y)) + 1):
                out[zi, y, xi] = 1.0
        else:
            slope = ((p2y - p1y) / (p2x - p1x) if p1x < p2x
                     else (p1y - p2y) / (p1x - p2x))
            b = p1y + 0.5 - (p1x + 0.5) * slope
            xd = x_start
            while xd <= x_end:
                yd = slope * xd + b
                xi, yi = int(xd), int(yd)
                if 0 <= yi <= ny - 1:
                    out[zi, yi, xi] = 1.0
                xd += step
    return out


def _pad_concat(src: np.ndarray, ref: np.ndarray):
    """Zero-pad two volumes to a common (nz, ny) and concat along x
    (draw_matches, sift.c:3049-3076; im_pad imutil.c:1471-1525)."""
    nz = max(src.shape[0], ref.shape[0])
    ny = max(src.shape[1], ref.shape[1])

    def pad(v):
        out = np.zeros((nz, ny, v.shape[2]), np.float32)
        out[:v.shape[0], :v.shape[1], :] = v
        return out
    return np.concatenate([pad(src), pad(ref)], axis=2), src.shape[2]


def draw_matches(src: np.ndarray, ref: np.ndarray,
                 match_src_xyz: np.ndarray, match_ref_xyz: np.ndarray,
                 keys: bool = True, lines: bool = True):
    """Visualize matches (draw_matches, sift.c:2990-3128).

    Returns dict with "background" (padded concat of src|ref), and
    optionally "keys" (points image) and "lines" (lines image), all
    (nz, ny, nx_src + nx_ref). Ref points are shifted by src's x extent.
    """
    bg, x_off = _pad_concat(np.asarray(src, np.float32),
                            np.asarray(ref, np.float32))
    dims_xyz = (bg.shape[2], bg.shape[1], bg.shape[0])
    ref_shifted = np.asarray(match_ref_xyz, np.float64).copy()
    ref_shifted[:, 0] += x_off
    out = {"background": bg}
    if keys:
        pts = np.concatenate([match_src_xyz, ref_shifted])
        out["keys"] = draw_points(pts, dims_xyz, radius=1)
    if lines:
        out["lines"] = draw_lines(match_src_xyz, ref_shifted, dims_xyz)
    return out
