"""Separable convolution in physical (mm) units.

The reference convolves each axis with a FIR filter whose taps are spaced
``unit`` mm apart, sampling the image with 1-D linear interpolation at
fractional voxel positions, and mirrors sampling coordinates at the
boundaries (reference imutil.c:2274-2393, apply_Sep_FIR_filter
imutil.c:3459-3544).

That operation is linear in the input, so each 1-D pass is exactly a
banded n x n matrix applied along one axis. The matrix is built on the
host (numpy, copied from ``sift3d_tpu/ops/conv.py``) and applied per
axis, in x, then y, then z order, in one of two fp32 forms:

- dense (``conv_axis``): one ``torch.matmul`` with the whole matrix,
  n MACs a voxel on an axis of length n;
- framed (``conv_axis_banded``, ``apply_banded_matrix``): the matrix cut
  into tiles of ``FRAME_TILE`` output rows, each applied to its frame of
  T + 2H padded input samples, T + 2H MACs a voxel whatever n is.

``conv_sep`` takes the framed form on axes of at least ``BANDED_MIN_N``
voxels.

The host matrices and tile sets are cached by their arguments
(``_conv_matrix_cached``, ``_frame_tiles_cached``); ``conv_sep`` keeps
the copy of each on a device (``device_operators``, keyed by the same
arguments plus device and dtype, held for the life of the process as the
host caches hold theirs), so a blur copies nothing from the host once
its operators are there. ``conv.w_uploads`` counts the host-to-device
copies of operators: a miss of that cache, or a host matrix handed to
``conv_axis``.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CONV_EPS
from ..utils import trace


@functools.lru_cache(maxsize=None)
def _conv_matrix_cached(taps_key, unit: float, unit_dim: float, n: int) -> np.ndarray:
    taps = np.asarray(taps_key, dtype=np.float32)
    return _make_conv_matrix(taps, unit, unit_dim, n)


def conv_matrix(taps: np.ndarray, unit: float, unit_dim: float, n: int) -> np.ndarray:
    """Banded convolution matrix W (n x n, float32): out = W @ signal.

    Args:
      taps: float32 filter taps, odd length 2*hw+1.
      unit: physical spacing of the filter taps (mm).
      unit_dim: physical voxel spacing of the image along this axis (mm).
      n: axis length.
    """
    return _conv_matrix_cached(tuple(np.asarray(taps, np.float32).tolist()),
                               float(unit), float(unit_dim), int(n))


def _make_conv_matrix(taps: np.ndarray, unit: float, unit_dim: float,
                      n: int) -> np.ndarray:
    hw = (len(taps) - 1) // 2
    # unit_factor is computed in float32 in the reference (imutil.c:2286-2287)
    uf = np.float32(unit / unit_dim)
    dim_end = n - 1
    d = np.arange(-hw, hw + 1, dtype=np.float32)
    step = d * uf                                    # float32, like the C code
    x = np.arange(n, dtype=np.float32)
    coords = x[:, None] - step[None, :]              # (n, ntaps), float32

    # Mirror boundaries exactly as convolve_sep_gen's second pass
    # (imutil.c:2375-2382). Conditions use truncation toward zero.
    lo0 = np.trunc(coords).astype(np.int64)
    neg = lo0 < 0
    coords = np.where(neg, (-coords).astype(np.float32), coords)
    hi = np.logical_and(~neg, np.trunc(coords).astype(np.int64) >= dim_end)
    coords = np.where(
        hi,
        (np.float32(2.0 * dim_end) - coords - np.float32(CONV_EPS)).astype(np.float32),
        coords)

    lo = np.trunc(coords).astype(np.int64)
    frac = (coords - lo.astype(np.float32)).astype(np.float32)
    # Clamp for safety (the reference reads out of bounds here; only reachable
    # for filters wider than the image, which the pyramid geometry forbids).
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(lo + 1, 0, n - 1)

    W = np.zeros((n, n), dtype=np.float64)
    rows = np.repeat(np.arange(n), len(taps))
    t64 = taps.astype(np.float64)[None, :] * np.ones((n, 1))
    np.add.at(W, (rows, lo_c.ravel()),
              (t64 * (1.0 - frac.astype(np.float64))).ravel())
    np.add.at(W, (rows, hi_c.ravel()),
              (t64 * frac.astype(np.float64)).ravel())
    return W.astype(np.float32)


def unit_half_width(taps_len: int, unit: float, unit_dim: float) -> int:
    """Half-width of the convolution's input footprint in voxels
    (imutil.c:2288-2289)."""
    hw = (taps_len - 1) // 2
    uf = np.float32(unit / unit_dim)
    return int(np.ceil(np.float32(hw) * uf))


def conv_axis(vol: torch.Tensor, W, axis: int) -> torch.Tensor:
    """Apply a 1-D operator along ``axis`` of ``vol``:
    out[..., i, ...] = sum_j W[i, j] vol[..., j, ...], one fp32 matmul.
    ``W`` is (n_out, n) for an axis of length n: square for a blur,
    rectangular for a sharded block or a composed pyramid operator. A
    host ``W`` is copied to ``vol``'s device on every call, counted as
    ``conv.w_uploads``."""
    return apply_form(vol, (None, W), axis)


# Axis length from which ``conv_sep`` and ``pyramid.apply_sep_ops`` take
# the framed form: the least measured n from which the framed form's min
# of 5 is at most 95% of the dense matmul's, at that n and at every larger
# measured n, on all three axes, for the pyramid's widest and narrowest
# octave-0 taps and the dense blur's (scripts/conv_banded_ab.py, run by
# chip_smoke.py phase 11, which asserts this choice). Measured on an
# NVIDIA H100 80GB HBM3 at 700 W, n in {128, 192, 256, 384, 512}, fp32
# without TF32, framed at T = 64 over dense in two runs: 0.75-1.43 at
# n = 256 (the x axis loses), 0.46-0.65 at 384, 0.32-0.42 at 512. So the
# 512^3 dense descriptors' blur is framed, while the 256^3 pyramid and
# the 64^3 batches stay dense.
BANDED_MIN_N = 384

# Output rows per frame tile. A tile costs T + 2H MACs an output voxel
# against the dense form's n. T = 64 was at most 0.88 of T = 128's time
# at every n, axis and tap set where the framed form is chosen (same run;
# T = 256 was slower than both), so it replaces 128 by the same 5% rule.
FRAME_TILE = 64


def band_half_width(W: np.ndarray) -> int:
    """Max |col - row| over the nonzeros of a square banded matrix."""
    rows, cols = np.nonzero(W)
    return int(np.abs(cols - rows).max()) if len(rows) else 0


def banded_frame_tiles(W: np.ndarray, tile: int | None = None):
    """Cut a square banded matrix into per-tile weight blocks of ``tile``
    output rows (``FRAME_TILE`` when None).

    Returns (H, tiles) with tiles (ntiles, T, T + 2H) float32 such that
    ``(W @ x)[t*T : (t+1)*T] == tiles[t] @ xp[t*T : t*T + T + 2H]`` where
    ``xp`` is x zero-padded by H low and H + (n_pad - n) high. Exact: the
    boundary tiles carry W's mirror rows; the interior tiles are one
    Toeplitz block."""
    n = W.shape[0]
    H = band_half_width(W)
    T = min(FRAME_TILE if tile is None else tile, n)
    ntiles = -(-n // T)
    n_pad = ntiles * T
    Wp = np.zeros((n_pad, n_pad + 2 * H), np.float32)
    Wp[:n, H:H + n] = W
    tiles = np.stack([Wp[t * T:(t + 1) * T, t * T:t * T + T + 2 * H]
                      for t in range(ntiles)])
    return H, tiles


def _frame(v: torch.Tensor, lo: int, K: int) -> torch.Tensor:
    """Samples [lo, lo + K) of the middle axis of ``v`` (lead, n, trail),
    zeros outside [0, n): a view where the frame lies inside the axis, a
    small padded copy at its ends."""
    n = v.shape[1]
    a, b = max(lo, 0), min(lo + K, n)
    if a == lo and b == lo + K:
        return v[:, a:b]
    return F.pad(v[:, a:b], (0, 0, a - lo, lo + K - b))


def _apply_frame_tiles(vol: torch.Tensor, H: int, tiles, axis: int,
                       out=None) -> torch.Tensor:
    """Apply a banded operator in (H, tiles) form along ``axis``.

    Tile t's output rows [t T, t T + T) are its (T, K) weights (K = T +
    2H) times its frame, input samples [t T - H, t T - H + K) with zeros
    outside the axis (``banded_frame_tiles``' padding). A frame inside the
    axis is a strided view of the input; only the end tiles copy theirs.
    One product a tile writes its rows of the output in place: a plain
    matmul along the last axis, a matmul a leading plane when there are
    fewer planes than tiles, else a matmul batched over the planes. fp32,
    T + 2H MACs an output voxel; the output (``out`` where it is given, a
    contiguous tensor of ``vol``'s shape) is the only full-size
    temporary. Host ``tiles`` are copied to ``vol``'s device on every
    call, counted as ``conv.w_uploads``."""
    axis = axis % vol.ndim
    shape = vol.shape
    n = shape[axis]
    ntiles, T, K = tiles.shape
    lead = int(np.prod(shape[:axis], dtype=np.int64))
    trail = int(np.prod(shape[axis + 1:], dtype=np.int64))
    v = vol.reshape(lead, n, trail)
    if not torch.is_tensor(tiles):
        trace.count("conv.w_uploads")
    Wt = torch.as_tensor(tiles, dtype=vol.dtype, device=vol.device)
    if out is None:
        out = torch.empty((lead, n, trail), dtype=vol.dtype,
                          device=vol.device)
    flat = out.view(lead, n, trail)
    for t in range(ntiles):
        r = min(T, n - t * T)              # the last tile's rows inside n
        x = _frame(v, t * T - H, K)
        o = flat[:, t * T:t * T + r]
        if trail == 1:
            torch.mm(x[..., 0], Wt[t, :r].T, out=o[..., 0])
        elif lead < ntiles:
            for i in range(lead):
                torch.mm(Wt[t, :r], x[i], out=o[i])
        else:
            torch.bmm(Wt[t, :r].expand(lead, r, K), x, out=o)
    return out.reshape(shape)


def matrix_form(W: np.ndarray) -> tuple:
    """How ``apply_banded_matrix`` applies the square banded matrix
    ``W`` (host numpy): ``banded_frame_tiles``' (H, tiles), or (None, W)
    for the dense matmul when the band is so wide (e.g. heavily composed
    pyramid operators) that framing would not cut the work a voxel."""
    W = np.asarray(W, np.float32)
    n = W.shape[0]
    if min(FRAME_TILE, n) + 2 * band_half_width(W) >= n:
        return None, W
    return banded_frame_tiles(W)


def apply_form(vol: torch.Tensor, form, axis: int, out=None):
    """Apply an operator in ``matrix_form``'s form (its array on the host,
    or already on ``vol``'s device) along ``axis``: the framed tiles
    where H is given, else ``conv_axis``'s dense matmul; written into
    ``out`` (a contiguous tensor of the result's shape) where it is
    given."""
    H, W = form
    if H is not None:
        return _apply_frame_tiles(vol, H, W, axis, out)
    if not torch.is_tensor(W):
        trace.count("conv.w_uploads")
    W = torch.as_tensor(W, dtype=vol.dtype, device=vol.device)
    axis = axis % vol.ndim
    if axis == vol.ndim - 1:
        return torch.matmul(vol, W.T, out=out)
    shape = vol.shape
    n = shape[axis]
    lead = int(np.prod(shape[:axis], dtype=np.int64))
    v = vol.reshape(lead, n, -1)
    flat = None if out is None else out.view(lead, W.shape[0], -1)
    return torch.matmul(W, v, out=flat).reshape(shape[:axis] + (W.shape[0],) +
                                                shape[axis + 1:])


def apply_forms(vol: torch.Tensor, forms, out=None) -> torch.Tensor:
    """Apply per-axis (x, y, z) operators in ``apply_form``'s form, x then
    y then z (apply_Sep_FIR_filter's order, imutil.c:3494-3526); the z
    pass written into ``out`` where it is given."""
    fx, fy, fz = forms
    vol = apply_form(vol, fx, -1)
    vol = apply_form(vol, fy, -2)
    return apply_form(vol, fz, -3, out)


def apply_banded_matrix(vol: torch.Tensor, W: np.ndarray,
                        axis: int) -> torch.Tensor:
    """Apply a square banded matrix (host numpy) along ``axis`` in
    ``matrix_form``'s form."""
    return apply_form(vol, matrix_form(W), axis)


@functools.lru_cache(maxsize=None)
def _frame_tiles_cached(taps_key, unit: float, unit_dim: float, n: int,
                        tile: int):
    return banded_frame_tiles(
        _conv_matrix_cached(taps_key, unit, unit_dim, n), tile)


# Device copies of host operators: (key, device, dtype) -> tensor, a key
# being ``_axis_key``'s or one of ``pyramid``'s composed operators. Entries
# are never evicted: they are as many as the host caches' entries times
# the devices and dtypes used.
_device_ops: dict = {}
_device_lock = threading.Lock()
# Each device copy starts at a multiple of this many elements of its
# upload's buffer, the caching allocator's 512-byte alignment in fp32.
_OP_ALIGN = 128


def _taps_key(taps) -> tuple:
    return tuple(np.asarray(taps, np.float32).tolist())


def _axis_key(taps_key, unit: float, unit_dim: float, n: int) -> tuple:
    """The key of ``conv_sep``'s operator on an axis of length ``n``: the
    framed tile set from ``BANDED_MIN_N`` voxels, else the dense matrix,
    each with its host cache's arguments."""
    if n >= BANDED_MIN_N:
        return ("tiles", taps_key, float(unit), float(unit_dim), int(n),
                FRAME_TILE)
    return ("W", taps_key, float(unit), float(unit_dim), int(n))


def _host_operator(key) -> np.ndarray:
    if key[0] == "W":
        return _conv_matrix_cached(*key[1:])
    return _frame_tiles_cached(*key[1:])[1]


def device_operators(keys, device, dtype, hosts=None) -> list:
    """The copies on ``device`` as ``dtype`` of the host operators
    ``keys``, in order: ``_axis_key``'s keys, or keys of ``hosts``, a
    mapping to the host arrays of operators built elsewhere (the composed
    operators of ``pyramid.build_gpyr_pipelined``). Those not yet there
    go up together, in one host-to-device copy (counted once as
    ``conv.w_uploads``), and are kept."""
    device = torch.device(device)
    want = [(k, device, dtype) for k in keys]
    with _device_lock:
        missing = list(dict.fromkeys(w for w in want
                                     if w not in _device_ops))
    if missing:
        hosts = [np.asarray(hosts[k] if hosts and k in hosts else
                            _host_operator(k), np.float32)
                 for k, _, _ in missing]
        offs = np.cumsum([0] + [-(-h.size // _OP_ALIGN) * _OP_ALIGN
                                for h in hosts])
        buf = np.zeros(int(offs[-1]), np.float32)
        for h, a in zip(hosts, offs):
            buf[a:a + h.size] = h.ravel()
        flat = torch.as_tensor(buf, dtype=dtype, device=device)
        trace.count("conv.w_uploads")
        with _device_lock:
            for w, h, a in zip(missing, hosts, offs):
                _device_ops.setdefault(
                    w, flat[a:a + h.size].view(h.shape))
    with _device_lock:
        return [_device_ops[w] for w in want]


def sep_keys(taps, unit: float, units, shape) -> list:
    """The keys of the x, y and z operators of ``conv_sep`` on a
    (..., nz, ny, nx) ``shape``: ``device_operators``' input, for a
    caller that loads many blurs' operators at once."""
    key = _taps_key(taps)
    return [_axis_key(key, unit, u, n)
            for u, n in zip(units, tuple(shape[-3:])[::-1])]


def _device_form(key, device, dtype) -> tuple:
    """The operator ``key`` (``_axis_key``'s) in ``apply_form``'s form,
    its array the copy on ``device`` from ``device_operators``."""
    op, = device_operators([key], device, dtype)
    return (_frame_tiles_cached(*key[1:])[0] if key[0] == "tiles" else None,
            op)


def sep_forms(vol: torch.Tensor, taps, unit: float, units) -> list:
    """``conv_sep``'s x, y and z operators for ``vol`` in ``apply_form``'s
    form, each kept on ``vol``'s device (``device_operators``, one copy
    an operator not yet there)."""
    return [_device_form(k, vol.device, vol.dtype)
            for k in sep_keys(taps, unit, units, vol.shape)]


def conv_axis_banded(vol: torch.Tensor, taps: np.ndarray, unit: float,
                     unit_dim: float, axis: int) -> torch.Tensor:
    """``conv_axis`` with ``conv_matrix(taps, unit, unit_dim, n)`` (the
    same matrix, mirror rows and mm-unit interpolated taps included) in
    the framed form: T + 2H MACs a voxel instead of n. The tile set is
    kept on ``vol``'s device (``device_operators``)."""
    n = vol.shape[axis % vol.ndim]
    key = ("tiles", _taps_key(taps), float(unit), float(unit_dim), int(n),
           FRAME_TILE)
    return apply_form(vol, _device_form(key, vol.device, vol.dtype), axis)


def conv_sep(vol: torch.Tensor, taps: np.ndarray, unit: float,
             units: tuple[float, float, float]) -> torch.Tensor:
    """Full separable pass over a (z, y, x)-ordered volume.

    Matches apply_Sep_FIR_filter's dimension order x, then y, then z
    (imutil.c:3494-3526). ``units`` is (ux, uy, uz). Axes of at least
    ``BANDED_MIN_N`` voxels take the framed form, shorter ones the dense
    matmul; each axis's operator is kept on ``vol``'s device
    (``sep_forms``)."""
    return apply_forms(vol, sep_forms(vol, taps, unit, units))
