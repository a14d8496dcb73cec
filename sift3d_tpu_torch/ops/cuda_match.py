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
- On the H100 it is bound by fp32 FMA throughput (2 Nq Nt 768 flops per
  direction against (Nq + Nt) 768 * 4 bytes).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..features.match import _consistent, _ratio_accept

# Targets per block of the plain version (the TPU kernel's block).
PLAIN_BLOCK = 512


def _top2_rows(d: torch.Tensor):
    """Per-row (best, second, argmin) of a block, ties to the lower col."""
    i0 = torch.argmin(d, dim=1, keepdim=True)
    b0 = torch.gather(d, 1, i0)
    b1 = torch.min(d.scatter(1, i0, float("inf")), dim=1, keepdim=True).values
    return b0, b1, i0


def reduce_one_way_plain(q, t, qsq, tsq, block: int = PLAIN_BLOCK):
    """The plain PyTorch version: per-query (best, second, idx), each
    (Nq,), over target blocks of ``block`` rows."""
    nq = q.shape[0]
    dev = q.device
    inf = float("inf")
    rb = torch.full((nq, 1), inf, device=dev)
    rs = torch.full((nq, 1), inf, device=dev)
    ri = torch.zeros((nq, 1), dtype=torch.int64, device=dev)
    for j0 in range(0, t.shape[0], block):
        g = torch.matmul(q, t[j0:j0 + block].T)
        d = qsq[:, None] + tsq[None, j0:j0 + block] - 2.0 * g
        d = torch.clamp(d, min=0.0)
        d = torch.where(torch.isnan(d), inf, d)
        b0, b1, i0 = _top2_rows(d)
        take = b0 < rb
        rs = torch.where(take, torch.minimum(rb, b1), torch.minimum(rs, b0))
        rb = torch.where(take, b0, rb)
        ri = torch.where(take, i0 + j0, ri)
    return rb[:, 0], rs[:, 0], ri[:, 0].to(torch.int32)


def _kernel_fn():
    fn = _build.load("match_stream").sift3d_match_top2
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


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
            q.shape[1] != t.shape[1]:
        raise ValueError("reduce_one_way: q and t must be float32 with the "
                         "same row width")
    q, t = q.contiguous(), t.contiguous()
    qsq = qsq.to(torch.float32).contiguous()
    tsq = tsq.to(torch.float32).contiguous()
    nq, dim = q.shape
    best = torch.empty(nq, dtype=torch.float32, device=q.device)
    second = torch.empty_like(best)
    idx = torch.empty(nq, dtype=torch.int32, device=q.device)
    if nq == 0:
        return best, second, idx
    err = _kernel_fn()(q.data_ptr(), t.data_ptr(), qsq.data_ptr(),
                       tsq.data_ptr(), nq, t.shape[0], dim, best.data_ptr(),
                       second.data_ptr(), idx.data_ptr(),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "match_stream launch")
    reduce_one_way.launches += 1
    return best, second, idx


reduce_one_way.launches = 0


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
