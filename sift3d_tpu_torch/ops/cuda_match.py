"""Streamed matcher: the CUDA kernel (``csrc/match_stream.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``_kernel`` of ``sift3d_tpu/ops/pallas_match.py``.
``reduce_one_way`` computes, for every query row, a running
(best, second, argmin) of SSD = |q|^2 + |t|^2 - 2 q.t over all target rows
without materializing the (Nq, Nt) matrix; SSD is clamped at >= 0 and NaN
becomes +inf; +inf norms mark invalid rows. Tie rules, as on the TPU:
within a block of targets the lower index wins; across blocks the earlier
(running) entry wins an exact tie; the second-best update is
``min(rb, b1)`` when the block takes the lead, else ``min(rs, b0)``.
``nn_match_streamed`` runs it once per direction and then applies the
ratio test and the forward/backward check in torch.

- ``reduce_one_way`` launches the kernel for CUDA tensors and runs
  ``reduce_one_way_plain`` for CPU tensors; there is no fallback.
- The kernel's dot product is an fp32 FMA chain (never TF32), so its SSD
  can differ from cuBLAS's in the last bits: a row's index can only differ
  from the dense matcher where two SSDs agree to fp32 rounding.
- Before, one block per 32-query tile streamed every target (79 blocks
  at 2500 queries, 5 at 146) with a 2 x 4 register tile that left it
  bound by shared-memory reads. Now the grid is query tiles x target
  ranges (``match_plan``: at least 2 x 132 blocks where the shapes allow
  it), each block writes a partial (best, second, idx) and a second pass
  folds the ranges in order; ``reduce_one_way_plain(..., bounds=...)`` and
  ``merge_top2`` are that split in plain PyTorch. Each SSD stays one fp32
  FMA chain over k in order, so the split changes no bit of the result.
- On the H100 it is bound by fp32 FMA throughput (2 Nq Nt 768 flops per
  direction against (Nq + Nt) 768 * 4 bytes) at large shapes, and by its
  two launches and 768-long FMA chains at the main path's ~150 x 150.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import NUM_SMS
from ..features.match import _consistent, _ratio_accept
from ..utils import trace

# Targets per block of the plain version (the TPU kernel's block).
PLAIN_BLOCK = 512


def _top2_rows(d: torch.Tensor):
    """Per-row (best, second, argmin) of a block, ties to the lower col."""
    i0 = torch.argmin(d, dim=1, keepdim=True)
    b0 = torch.gather(d, 1, i0)
    b1 = torch.min(d.scatter(1, i0, float("inf")), dim=1, keepdim=True).values
    return b0, b1, i0


def _reduce_range(q, t, qsq, tsq, j_lo, j_hi, block):
    """(best, second, idx) of each query over targets [j_lo, j_hi), folded
    block by block; (+inf, +inf, 0) where no SSD is finite."""
    nq = q.shape[0]
    dev = q.device
    inf = float("inf")
    rb = torch.full((nq, 1), inf, device=dev)
    rs = torch.full((nq, 1), inf, device=dev)
    ri = torch.zeros((nq, 1), dtype=torch.int64, device=dev)
    for j0 in range(j_lo, j_hi, block):
        j1 = min(j_hi, j0 + block)
        g = torch.matmul(q, t[j0:j1].T)
        d = qsq[:, None] + tsq[None, j0:j1] - 2.0 * g
        d = torch.clamp(d, min=0.0)
        d = torch.where(torch.isnan(d), inf, d)
        b0, b1, i0 = _top2_rows(d)
        take = b0 < rb
        rs = torch.where(take, torch.minimum(rb, b1), torch.minimum(rs, b0))
        rb = torch.where(take, b0, rb)
        ri = torch.where(take, i0 + j0, ri)
    return rb[:, 0], rs[:, 0], ri[:, 0].to(torch.int32)


def merge_top2(partials):
    """Fold per-range (best, second, idx) partials in range order with the
    kernel's ``combine``: lexicographic on (SSD, index), the second-best
    the smaller of the loser's best and the winner's second."""
    b0, b1, i0 = partials[0]
    for ob0, ob1, oi0 in partials[1:]:
        other = (ob0 < b0) | ((ob0 == b0) & (oi0 < i0))
        b1 = torch.where(other, torch.minimum(b0, ob1),
                         torch.minimum(b1, ob0))
        b0 = torch.where(other, ob0, b0)
        i0 = torch.where(other, oi0, i0)
    return b0, b1, i0


def reduce_one_way_plain(q, t, qsq, tsq, block: int = PLAIN_BLOCK,
                         bounds=None):
    """The plain PyTorch version: per-query (best, second, idx), each
    (Nq,), over target blocks of ``block`` rows. With ``bounds`` (target
    range starts, the first 0) each range is reduced alone and the
    partials are merged by ``merge_top2``, as the kernel splits its grid."""
    nt = t.shape[0]
    if bounds is None:
        return _reduce_range(q, t, qsq, tsq, 0, nt, block)
    ends = list(bounds[1:]) + [nt]
    return merge_top2([_reduce_range(q, t, qsq, tsq, lo, hi, block)
                       for lo, hi in zip(bounds, ends)])


def match_plan(nq: int, nt: int) -> tuple[int, int, int]:
    """The kernel's (tile side, target tiles per range, ranges) for one
    direction: 128 x 128 tiles where they alone give at least one block
    per SM, else 32 x 32; then target ranges so that query tiles x ranges
    reaches 2 x NUM_SMS where the target tiles allow it."""
    side = 128
    if -(-nq // side) * -(-nt // side) < NUM_SMS:
        side = 32
    q_tiles, t_tiles = -(-nq // side), -(-nt // side)
    want = -(-2 * NUM_SMS // max(1, q_tiles))
    per = max(1, t_tiles // want)
    return side, per, max(1, -(-t_tiles // per))


def _kernel_fn():
    fn = _build.load("match_stream").sift3d_match_top2
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _f32_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous 16-byte-aligned f32, copied only if needed."""
    if x.dtype != torch.float32 or not x.is_contiguous() or \
            x.data_ptr() % 16:
        x = x.to(torch.float32).clone(memory_format=torch.contiguous_format)
    return x


def reduce_one_way(q: torch.Tensor, t: torch.Tensor, qsq: torch.Tensor,
                   tsq: torch.Tensor):
    """Per-query (best, second, idx) over all targets.

    q (Nq, D), t (Nt, D) f32; qsq (Nq,), tsq (Nt,) f32 squared norms with
    +inf marking invalid rows. Returns best, second (Nq,) f32 and idx (Nq,)
    i32; a row with no finite SSD keeps best = +inf and idx = 0.
    """
    if q.device.type == "cpu":
        return reduce_one_way_plain(q, t, qsq, tsq)
    if q.device.type != "cuda":
        raise ValueError(f"reduce_one_way: unsupported device {q.device}")
    if q.dtype != torch.float32 or t.dtype != torch.float32 or \
            q.shape[1] != t.shape[1] or q.shape[1] % 4:
        raise ValueError("reduce_one_way: q and t must be float32 with the "
                         "same row width, a multiple of 4")
    q, t, qsq, tsq = (_f32_rows(x) for x in (q, t, qsq, tsq))
    nq, dim = q.shape
    nt = t.shape[0]
    side, per, ranges = match_plan(nq, nt)
    # Outputs and the per-range partials in one allocation.
    words = 3 * nq * (1 + (ranges if ranges > 1 else 0))
    buf = torch.empty(words, dtype=torch.float32, device=q.device)
    best, second = buf[:nq], buf[nq:2 * nq]
    idx = buf[2 * nq:3 * nq].view(torch.int32)
    if nq == 0:
        return best, second, idx
    err = _kernel_fn()(q.data_ptr(), t.data_ptr(), qsq.data_ptr(),
                       tsq.data_ptr(), nq, nt, dim, side, per, ranges,
                       best.data_ptr(), second.data_ptr(), idx.data_ptr(),
                       buf[3 * nq:].data_ptr() if ranges > 1 else None,
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "match_stream launch")
    trace.count("launches.match_stream")
    return best, second, idx



def match_reduce_streamed(d1: torch.Tensor, d2: torch.Tensor,
                          valid1: torch.Tensor | None = None,
                          valid2: torch.Tensor | None = None):
    """Both directions' top-2 reductions. Returns
    ``(fbest, fsecond, fidx, bbest, bsecond, bidx)`` with shapes
    (N1,), (N1,), (N1,), (N2,), (N2,), (N2,)."""
    d1 = d1.float()
    d2 = d2.float()
    inf = float("inf")
    n1sq = torch.sum(d1 * d1, dim=1)
    n2sq = torch.sum(d2 * d2, dim=1)
    if valid1 is not None:
        n1sq = torch.where(valid1, n1sq, inf)
    if valid2 is not None:
        n2sq = torch.where(valid2, n2sq, inf)
    fwd = reduce_one_way(d1, d2, n1sq, n2sq)
    bwd = reduce_one_way(d2, d1, n2sq, n1sq)
    return fwd + bwd


def nn_match_streamed(d1: torch.Tensor, d2: torch.Tensor, nn_thresh: float,
                      valid1: torch.Tensor | None = None,
                      valid2: torch.Tensor | None = None) -> torch.Tensor:
    """``features.match.nn_match`` with O(N1 + N2) device memory."""
    fbest, fsecond, fidx, bbest, bsecond, bidx = match_reduce_streamed(
        d1, d2, valid1=valid1, valid2=valid2)
    fidx = fidx.long()
    ok = _consistent(fidx, _ratio_accept(fbest, fsecond, nn_thresh),
                     bidx.long(), _ratio_accept(bbest, bsecond, nn_thresh))
    # fidx of an all-invalid row is 0 (never accepted: fbest == +inf).
    ok = ok & torch.isfinite(fbest)
    if valid1 is not None:
        ok = ok & valid1
    return torch.where(ok, fidx, -1).to(torch.int32)
