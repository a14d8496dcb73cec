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
// the global first-index argmin and the second-smallest SSD (duplicates
// counted), whatever the tiling or the split. One call is one direction;
// the ratio test and the forward/backward check run in torch.
//
// What bounded the first design: one block of 256 threads per 32-query
// tile streamed every target past it, so 2500 queries made 79 blocks for
// 132 SMs (5 blocks at 146 queries), and each thread's 2 x 4 register tile
// did 8 FMAs per float2 + float4 read from shared memory, so shared-memory
// bandwidth set the pace (about 9% of the fp32 rate at 2500 x 2300).
//
// Design now:
//   - The grid is query tiles x target ranges: a block reduces its query
//     tile over one contiguous range of target tiles and writes a partial
//     (best, second, idx) per query; a second small pass folds the ranges
//     in order with `combine`, which is lexicographic on (SSD, index), so
//     the split changes no result. The wrapper picks the ranges so that
//     the grid holds at least 2 x 132 blocks where the shapes allow it;
//     with one range the block writes the result itself.
//   - Two tile shapes from one template: 128 x 128 (8 x 8 outputs per
//     thread, two float4 fragment reads per operand per k: 64 FMAs for 4
//     loads) where there are enough tiles to fill the card, else 32 x 32
//     (2 x 2 per thread) so that small sets still spread over many SMs.
//   - k-chunks of 16 are double-buffered: the next chunk is loaded from
//     global memory into registers while the current one is multiplied,
//     then stored transposed into the other shared buffer (one barrier per
//     chunk).
//   - Every SSD is one fp32 FMA chain over k in increasing order from 0,
//     then (|q|^2 + |t|^2) - 2 acc, as in the first design: no k-split, no
//     TF32, no tensor cores, so best and second are bitwise those of the
//     first design and indices equal an IEEE fp32 dot product's.
//
// What bounds it now: fp32 FMA throughput in the 128 x 128 shape (one
// direction is Nq * Nt * 768 FMAs against (Nq + Nt) * 768 * 4 bytes of
// descriptors, far above the fp32 ridge point), and at the main path's
// ~150 x 150 the two launches and the 768-long dependent FMA chains.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;     // threads along each side of the output tile
constexpr int kBK = 16;       // k-chunk staged through shared memory
constexpr int kPad = 4;

// Fold candidate (ob0, ob1, oi0) into (b0, b1, i0): lexicographic on
// (value, index), so the result is the same on both sides of a shuffle and
// whatever the order of the ranges.
__device__ __forceinline__ void combine(float& b0, float& b1, int& i0,
                                        float ob0, float ob1, int oi0) {
  const bool other = (ob0 < b0) || (ob0 == b0 && oi0 < i0);
  const float nb1 = other ? fminf(b0, ob1) : fminf(b1, ob0);
  b0 = other ? ob0 : b0;
  i0 = other ? oi0 : i0;
  b1 = nb1;
}

// V consecutive floats from shared memory (16-byte or 8-byte aligned).
template <int V>
__device__ __forceinline__ void load_frag(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = p[0];
  }
}

// TM x TM outputs per thread; the block tile is (16 TM) x (16 TM). Thread
// (ty, tx) owns rows {h * 16 V + ty * V + v} and columns {h * 16 V + tx * V
// + v} (V = min(TM, 4)), so each fragment read is one vector per piece and
// its columns are scanned in increasing order.
template <int TM>
__global__ void __launch_bounds__(kThreads, TM == 8 ? 2 : 4)
match_top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const float* __restrict__ qsq,
                  const float* __restrict__ tsq, int nq, int nt, int dim,
                  int tiles_per_range, float* __restrict__ best_out,
                  float* __restrict__ second_out, int* __restrict__ idx_out) {
  constexpr int V = TM < 4 ? TM : 4;
  constexpr int H = TM / V;
  constexpr int B = kSide * TM;                       // tile side
  constexpr int kVecs = B * kBK / 4;                  // float4 per operand
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  __shared__ __align__(16) float qs[2][kBK][B + kPad];
  __shared__ __align__(16) float ts[2][kBK][B + kPad];
  __shared__ float s_rb[B], s_rs[B];
  __shared__ int s_ri[B];

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int q0 = blockIdx.x * B;
  const int n_tiles = (nt + B - 1) / B;
  const int tile0 = blockIdx.y * tiles_per_range;
  const int tile1 = min(n_tiles, tile0 + tiles_per_range);
  const int nk = (dim + kBK - 1) / kBK;
  const float inf = __int_as_float(0x7f800000);

  for (int i = tid; i < B; i += kThreads) {
    s_rb[i] = inf;
    s_rs[i] = inf;
    s_ri[i] = 0;
  }

  float4 rq[kLoads], rt[kLoads];
  // Global -> registers: chunk kc of the query tile and of target tile t0.
  auto fetch = [&](int kc, int t0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / (kBK / 4), c = kc * kBK + (e % (kBK / 4)) * 4;
      const bool in = e < kVecs && c < dim;
      const int qr = q0 + r, tr = t0 + r;
      rq[l] = (in && qr < nq)
                  ? *reinterpret_cast<const float4*>(
                        q + static_cast<size_t>(qr) * dim + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      rt[l] = (in && tr < nt)
                  ? *reinterpret_cast<const float4*>(
                        t + static_cast<size_t>(tr) * dim + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // Registers -> shared buffer `buf`, transposed to [k][row].
  auto stash = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      if (e >= kVecs) continue;
      const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
      qs[buf][c][r] = rq[l].x; qs[buf][c + 1][r] = rq[l].y;
      qs[buf][c + 2][r] = rq[l].z; qs[buf][c + 3][r] = rq[l].w;
      ts[buf][c][r] = rt[l].x; ts[buf][c + 1][r] = rt[l].y;
      ts[buf][c + 2][r] = rt[l].z; ts[buf][c + 3][r] = rt[l].w;
    }
  };

  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * B;
    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

    fetch(0, t0);
    stash(0);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      const int buf = kc & 1;
      if (kc + 1 < nk) fetch(kc + 1, t0);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TM];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          load_frag<V>(&qs[buf][kk][h * kSide * V + ty * V], a + h * V);
          load_frag<V>(&ts[buf][kk][h * kSide * V + tx * V], b + h * V);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (kc + 1 < nk) stash(buf ^ 1);
      __syncthreads();
    }

    float tn[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int col = t0 + (j / V) * kSide * V + tx * V + j % V;
      tn[j] = col < nt ? tsq[col] : inf;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lrow = (i / V) * kSide * V + ty * V + i % V;
      const int row = q0 + lrow;
      const float qn = row < nq ? qsq[row] : inf;
      // This thread's candidates, in increasing column order.
      float b0 = inf, b1 = inf;
      int i0 = t0 + tx * V;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = t0 + (j / V) * kSide * V + tx * V + j % V;
        float d = inf;
        if (col < nt) {
          d = (qn + tn[j]) - 2.0f * acc[i][j];
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
      for (int off = kSide / 2; off > 0; off >>= 1) {
        const float ob0 = __shfl_xor_sync(0xffffffffu, b0, off);
        const float ob1 = __shfl_xor_sync(0xffffffffu, b1, off);
        const int oi0 = __shfl_xor_sync(0xffffffffu, i0, off);
        combine(b0, b1, i0, ob0, ob1, oi0);
      }
      // Fold the tile into the row's running state (owned by lane tx 0);
      // exact ties keep the earlier entry.
      if (tx == 0) {
        const float rb = s_rb[lrow];
        const bool take = b0 < rb;
        s_rs[lrow] = take ? fminf(rb, b1) : fminf(s_rs[lrow], b0);
        s_ri[lrow] = take ? i0 : s_ri[lrow];
        s_rb[lrow] = take ? b0 : rb;
      }
    }
  }

  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.y) * nq;
  for (int i = tid; i < B; i += kThreads) {
    const int row = q0 + i;
    if (row < nq) {
      best_out[base + row] = s_rb[i];
      second_out[base + row] = s_rs[i];
      idx_out[base + row] = s_ri[i];
    }
  }
}

// Fold the per-range partials (ranges, nq) of each query in range order.
__global__ void merge_ranges_kernel(const float* __restrict__ pb,
                                    const float* __restrict__ ps,
                                    const int* __restrict__ pi, int nq,
                                    int ranges, float* __restrict__ best,
                                    float* __restrict__ second,
                                    int* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nq) return;
  float b0 = pb[row], b1 = ps[row];
  int i0 = pi[row];
  for (int r = 1; r < ranges; ++r) {
    const size_t o = static_cast<size_t>(r) * nq + row;
    combine(b0, b1, i0, pb[o], ps[o], pi[o]);
  }
  best[row] = b0;
  second[row] = b1;
  idx[row] = i0;
}

}  // namespace

// One direction of the streamed matcher. q (nq, dim), t (nt, dim) f32
// row-major, 16-byte aligned, dim a multiple of 4; qsq (nq,), tsq (nt,)
// f32 squared norms (+inf = invalid row); tile the output tile side (128 or
// 32); ranges target ranges of tiles_per_range tiles each; outputs best,
// second (nq,) f32 and idx (nq,) i32; scratch 3 * ranges * nq words
// (unused when ranges == 1). Returns cudaGetLastError() after the
// launches.
extern "C" int sift3d_match_top2(const float* q, const float* t,
                                 const float* qsq, const float* tsq, int nq,
                                 int nt, int dim, int tile,
                                 int tiles_per_range, int ranges, float* best,
                                 float* second, int* idx, void* scratch,
                                 void* stream) {
  if (nq <= 0) return 0;
  if ((tile != 128 && tile != 32) || ranges < 1 || dim % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pb = best;
  float* ps = second;
  int* pi = idx;
  if (ranges > 1) {
    pb = static_cast<float*>(scratch);
    ps = pb + static_cast<size_t>(ranges) * nq;
    pi = reinterpret_cast<int*>(ps + static_cast<size_t>(ranges) * nq);
  }
  const dim3 grid((nq + tile - 1) / tile, ranges);
  if (tile == 128) {
    match_top2_kernel<8><<<grid, kThreads, 0, s>>>(
        q, t, qsq, tsq, nq, nt, dim, tiles_per_range, pb, ps, pi);
  } else {
    match_top2_kernel<2><<<grid, kThreads, 0, s>>>(
        q, t, qsq, tsq, nq, nt, dim, tiles_per_range, pb, ps, pi);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return static_cast<int>(err);
  merge_ranges_kernel<<<(nq + 127) / 128, 128, 0, s>>>(pb, ps, pi, nq, ranges,
                                                       best, second, idx);
  return static_cast<int>(cudaGetLastError());
}
