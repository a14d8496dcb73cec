// Streamed descriptor-matching top-2 kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of sift3d_tpu/ops/pallas_match.py
// (launched by `_reduce_one_way`). For every query row it keeps a running
// (best, second, argmin) of SSD = |q|^2 + |t|^2 - 2 q.t over all target
// rows, never materializing the (Nq, Nt) SSD matrix (reference
// SIFT3D_nn_match / match_desc, sift3d/sift.c:2840-2969). SSD is clamped
// at >= 0 and NaN becomes +inf; +inf squared norms mark invalid rows.
// Tie rules: inside one target tile the lower index wins; across tiles the
// running (earlier) entry wins an exact tie; the second-best update is
// min(rb, b1) when the tile takes the lead, else min(rs, b0). The result is
// the global first-index argmin and the second-smallest SSD, whatever the
// tiling. One launch is one direction; the ratio test and the
// forward/backward check run in torch.
//
// Design: one block of 256 threads per tile of 32 queries; target tiles of
// 64 rows stream past it. Query and target chunks of 32 dimensions are
// staged through shared memory (transposed, so each thread reads its rows
// and columns as float2/float4); each thread accumulates a 2 x 4 tile of
// dot products as an fp32 FMA chain in registers (never TF32 tensor cores:
// the index result must agree with an IEEE fp32 dot product), then the 16
// threads that share a query row reduce their candidates with warp
// shuffles and fold them into the running state held in registers.
//
// What bounds it on the H100: fp32 FMA throughput. One direction does
// Nq * Nt * 768 FMAs against (Nq + Nt) * 768 * 4 bytes of descriptors, far
// above the card's fp32 ridge point; target tiles are re-read from L2 by
// every query tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;                    // threads sharing a row
constexpr int kRowsPerThread = 2;
constexpr int kColsPerThread = 4;
constexpr int kTQ = (kThreads / kLanesPerRow) * kRowsPerThread;   // 32
constexpr int kTT = kLanesPerRow * kColsPerThread;               // 64
constexpr int kTK = 32;
constexpr int kPad = 4;

// Fold candidate (ob0, ob1, oi0) into (b0, b1, i0): lexicographic on
// (value, index), so the result is the same on both sides of a shuffle.
__device__ __forceinline__ void combine(float& b0, float& b1, int& i0,
                                        float ob0, float ob1, int oi0) {
  const bool other = (ob0 < b0) || (ob0 == b0 && oi0 < i0);
  const float nb1 = other ? fminf(b0, ob1) : fminf(b1, ob0);
  b0 = other ? ob0 : b0;
  i0 = other ? oi0 : i0;
  b1 = nb1;
}

__global__ void __launch_bounds__(kThreads) match_top2_kernel(
    const float* __restrict__ q, const float* __restrict__ t,
    const float* __restrict__ qsq, const float* __restrict__ tsq, int nq,
    int nt, int dim, float* __restrict__ best_out,
    float* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float qs[kTK][kTQ + kPad];
  __shared__ __align__(16) float ts[kTK][kTT + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRow;
  const int ty = tid / kLanesPerRow;
  const int q0 = blockIdx.x * kTQ;
  const float inf = __int_as_float(0x7f800000);

  float rb[kRowsPerThread], rs[kRowsPerThread], qn[kRowsPerThread];
  int ri[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty * kRowsPerThread + i;
    rb[i] = inf;
    rs[i] = inf;
    ri[i] = 0;
    qn[i] = row < nq ? qsq[row] : inf;
  }

  for (int t0 = 0; t0 < nt; t0 += kTT) {
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < dim; k0 += kTK) {
      for (int e = tid; e < kTQ * kTK; e += kThreads) {
        const int r = e / kTK, c = e % kTK;
        const int row = q0 + r, col = k0 + c;
        qs[c][r] = (row < nq && col < dim)
                       ? q[static_cast<size_t>(row) * dim + col] : 0.0f;
      }
      for (int e = tid; e < kTT * kTK; e += kThreads) {
        const int r = e / kTK, c = e % kTK;
        const int row = t0 + r, col = k0 + c;
        ts[c][r] = (row < nt && col < dim)
                       ? t[static_cast<size_t>(row) * dim + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float2 a =
            *reinterpret_cast<const float2*>(&qs[kk][ty * kRowsPerThread]);
        const float4 b =
            *reinterpret_cast<const float4*>(&ts[kk][tx * kColsPerThread]);
        const float av[kRowsPerThread] = {a.x, a.y};
        const float bv[kColsPerThread] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      // This thread's candidates, in increasing column order.
      float b0 = inf, b1 = inf;
      int i0 = t0 + tx * kColsPerThread;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = t0 + tx * kColsPerThread + j;
        float d = inf;
        if (col < nt) {
          d = (qn[i] + tsq[col]) - 2.0f * acc[i][j];
          if (isnan(d)) {
            d = inf;
          } else if (d < 0.0f) {
            d = 0.0f;
          }
        }
        if (d < b0) {
          b1 = b0;
          b0 = d;
          i0 = col;
        } else if (d < b1) {
          b1 = d;
        }
      }
      // Reduce over the 16 lanes of this row (a half-warp).
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
        const float ob0 = __shfl_xor_sync(0xffffffffu, b0, off);
        const float ob1 = __shfl_xor_sync(0xffffffffu, b1, off);
        const int oi0 = __shfl_xor_sync(0xffffffffu, i0, off);
        combine(b0, b1, i0, ob0, ob1, oi0);
      }
      // Fold the tile into the running state; exact ties keep the
      // earlier entry.
      const bool take = b0 < rb[i];
      rs[i] = take ? fminf(rb[i], b1) : fminf(rs[i], b0);
      ri[i] = take ? i0 : ri[i];
      rb[i] = take ? b0 : rb[i];
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + ty * kRowsPerThread + i;
      if (row < nq) {
        best_out[row] = rb[i];
        second_out[row] = rs[i];
        idx_out[row] = ri[i];
      }
    }
  }
}

}  // namespace

// One direction of the streamed matcher. q (nq, dim), t (nt, dim) f32
// row-major; qsq (nq,), tsq (nt,) f32 squared norms (+inf = invalid row);
// outputs best, second (nq,) f32 and idx (nq,) i32. Returns
// cudaGetLastError() after the launch.
extern "C" int sift3d_match_top2(const float* q, const float* t,
                                 const float* qsq, const float* tsq, int nq,
                                 int nt, int dim, float* best, float* second,
                                 int* idx, void* stream) {
  if (nq <= 0) return 0;
  const int blocks = (nq + kTQ - 1) / kTQ;
  match_top2_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q, t, qsq, tsq, nq, nt, dim, best, second, idx);
  return static_cast<int>(cudaGetLastError());
}
