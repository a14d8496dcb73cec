// SIFT3D DoG extrema kernels for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package forms the extrema mask with XLA's
// elementwise operations and compacts it with a cumsum and `nonzero`
// (sift3d_tpu/features/extrema.py). The port's plain twin,
// features/extrema.py (`extrema_mask` and the scan), did the same on the
// card: about 30 compare and `&` passes over each DoG level, an int32
// cumsum over the whole level for the capacity cap, and one host read a
// level for `nonzero`. These kernels find the same rows, bit for bit, for
// every keypoint level of a detection at once:
//
//   1. max pass: each volume's max |cur| of each level (atomicMax on the
//      bits of non-negative floats, which order as unsigned ints, so the
//      result does not depend on the order of the blocks);
//   2. count pass: the strict test of extrema_mask at each interior voxel,
//      t = fp32(peak_thresh) * max as one fp32 product, |c| > t and c
//      strictly above (or below) its 6 neighbours and the centres of the
//      previous and next levels; each block owns a run of whole interior
//      rows of one volume, in scan order (z, then y, then x), and writes
//      its hit count; the (level, volume) totals are integer atomics;
//   3. (the wrapper) exclusive prefixes of the block counts and of the
//      clamped counts, and the one host read of the counts;
//   4. emit pass: only blocks with hits below the level's capacity go on;
//      a row's rank in its volume is its block's prefix plus its rank in
//      the block, taken by warp ballots and popcounts in scan order, and
//      rows of rank below the capacity are written as (volume, z, y, x)
//      int32 at their volume's start in the level's slice: the order of
//      torch.nonzero on the capped mask.
//
// No mask is written to device memory. What bounds it on the H100: bytes.
// The max pass reads each level once; the count pass reads cur once (its
// neighbours come from L1 and L2: a z +- 1 plane of an octave-0 MNI152
// level is 159 KB) and prev and next only where |c| passes the threshold,
// which most voxels do not; the emit pass reads again only the blocks
// that hold rows. Each warp keeps kUnroll 128-byte loads in flight.

#include <cuda_runtime.h>

constexpr int kMaxLevels = 32;

// One level of a launch; mirrored by `_Level` in ops/cuda_extrema.py. At
// namespace scope, since the C entry points take an array of it.
struct Sift3dExtremaLevel {
  const float* prev;    // (B, nz, ny, nx) DoG levels s - 1, s, s + 1
  const float* cur;
  const float* next;
  int nz, ny, nx;
  int rows;             // interior rows a volume: (nz - 2) (ny - 2)
  int rows_per_block;   // interior rows of a count / emit block
  int chunks;           // count / emit blocks a volume
  int block0;           // first count / emit block of the level in a launch
  int max_chunks;       // max-pass blocks a volume
  int max_block0;       // first max-pass block of the level in a launch
  int seg0;             // (level, volume 0) in the per-(level, volume) arrays
  int capacity;         // rows kept a volume
  long long gblock0;    // first count block in the call's block counts
};
static_assert(sizeof(Sift3dExtremaLevel) == 80,
              "mirrored by _Level in ops/cuda_extrema.py");

struct Sift3dExtremaTable {
  Sift3dExtremaLevel lv[kMaxLevels];
  int num_levels;
};
static_assert(sizeof(Sift3dExtremaTable) + 8 * sizeof(void*) <= 4096,
              "kernel parameters must fit in 4 KB");

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 32-voxel chunks of a row whose loads a warp has in flight together.
constexpr int kUnroll = 4;
// Values of one volume a max-pass block reduces (ops/cuda_extrema.py
// MAX_BLOCK_VALUES).
constexpr int kMaxValues = 4096;
constexpr unsigned kFull = 0xffffffffu;

// The level of a block: the last whose first block is at or before it.
__device__ __forceinline__ int level_of(const Sift3dExtremaTable& t,
                                        int block, bool max_pass) {
  int l = 0;
  while (l + 1 < t.num_levels &&
         block >= (max_pass ? t.lv[l + 1].max_block0 : t.lv[l + 1].block0))
    ++l;
  return l;
}

// One volume of one level as the count and emit passes read it.
struct View {
  const float* prev;
  const float* cur;
  const float* next;
  int ny, nx, plane;    // extents and strides (elements)
  int NX, NY;           // interior extents of x and y
  float t;              // the threshold
};

__device__ __forceinline__ View view_of(const Sift3dExtremaLevel& L, int b,
                                        float t) {
  const size_t vol = static_cast<size_t>(b) * L.nz * L.ny * L.nx;
  View v;
  v.prev = L.prev + vol;
  v.cur = L.cur + vol;
  v.next = L.next + vol;
  v.ny = L.ny;
  v.nx = L.nx;
  v.plane = L.ny * L.nx;
  v.NX = L.nx - 2;
  v.NY = L.ny - 2;
  v.t = t;
  return v;
}

// Volume offset of interior row r's first interior voxel.
__device__ __forceinline__ int row_offset(const View& v, int r, int* z,
                                          int* y) {
  *z = r / v.NY;
  *y = r - *z * v.NY;
  return ((*z + 1) * v.ny + (*y + 1)) * v.nx + 1;
}

// extrema_mask's test at volume offset o, c = cur[o]: |c| beyond t, and
// strictly above or strictly below all eight values it is compared with.
// The neighbours are loaded only where |c| passes; the result is the same.
__device__ __forceinline__ bool is_extremum(const View& v, int o, float c) {
  if (!(c > v.t || c < -v.t)) return false;
  const float p = __ldg(v.prev + o), n = __ldg(v.next + o);
  const float xp = __ldg(v.cur + o + 1), xm = __ldg(v.cur + o - 1);
  const float yp = __ldg(v.cur + o + v.nx), ym = __ldg(v.cur + o - v.nx);
  const float zp = __ldg(v.cur + o + v.plane),
              zm = __ldg(v.cur + o - v.plane);
  const bool mx = (c > p) & (c > n) & (c > xp) & (c > xm) & (c > yp) &
                  (c > ym) & (c > zp) & (c > zm);
  const bool mn = (c < p) & (c < n) & (c < xp) & (c < xm) & (c < yp) &
                  (c < ym) & (c < zp) & (c < zm);
  return mx | mn;
}

// The warp's ballots of hits in kUnroll 32-voxel chunks of a row, from
// interior x = x0 (its loads issued before any test).
__device__ __forceinline__ void ballots(const View& v, int row, int x0,
                                        int lane, unsigned (&m)[kUnroll]) {
  float c[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int x = x0 + 32 * u + lane;
    c[u] = x < v.NX ? __ldg(v.cur + row + x) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int x = x0 + 32 * u + lane;
    m[u] = __ballot_sync(kFull, x < v.NX && is_extremum(v, row + x, c[u]));
  }
}

// Hits of interior row r (the same count in every lane).
__device__ __forceinline__ int row_hits(const View& v, int r, int lane) {
  int z, y;
  const int row = row_offset(v, r, &z, &y);
  int n = 0;
  for (int x0 = 0; x0 < v.NX; x0 += 32 * kUnroll) {
    unsigned m[kUnroll];
    ballots(v, row, x0, lane, m);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) n += __popc(m[u]);
  }
  return n;
}

// Sum of the block's per-warp values, in every thread (part: kWarps ints of
// shared memory, free again when this returns).
__device__ __forceinline__ int block_sum(int n, int* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = n;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads) max_kernel(
    const Sift3dExtremaTable t, unsigned* __restrict__ dogmax) {
  const int l = level_of(t, blockIdx.x, true);
  const Sift3dExtremaLevel& L = t.lv[l];
  const int k = blockIdx.x - L.max_block0;
  const int b = k / L.max_chunks, chunk = k - b * L.max_chunks;
  const int size = L.nz * L.ny * L.nx;
  const float* c = L.cur + static_cast<size_t>(b) * size;
  const int i1 = min((chunk + 1) * kMaxValues, size);
  float m = 0.0f;
  for (int i = chunk * kMaxValues + threadIdx.x; i < i1;
       i += kUnroll * kThreads) {
    float a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      a[u] = j < i1 ? fabsf(__ldg(c + j)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, a[u]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(kFull, m, off));
  __shared__ float part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, part[w]);
    atomicMax(dogmax + L.seg0 + b, __float_as_uint(m));
  }
}

// The threshold of volume b of level L: fp32(peak_thresh) * max, one fp32
// product, as extrema_mask forms it.
__device__ __forceinline__ float threshold(float peak,
                                           const unsigned* dogmax, int seg) {
  return __fmul_rn(peak, __uint_as_float(dogmax[seg]));
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    const Sift3dExtremaTable t, float peak,
    const unsigned* __restrict__ dogmax, int* __restrict__ total,
    int* __restrict__ seg_cap, int* __restrict__ block_counts) {
  const int l = level_of(t, blockIdx.x, false);
  const Sift3dExtremaLevel& L = t.lv[l];
  const int k = blockIdx.x - L.block0;
  const int b = k / L.chunks, chunk = k - b * L.chunks;
  const int seg = L.seg0 + b;
  const View v = view_of(L, b, threshold(peak, dogmax, seg));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = chunk * L.rows_per_block;
  const int r1 = min(r0 + L.rows_per_block, L.rows);
  int n = 0;
  for (int r = r0 + warp; r < r1; r += kWarps) n += row_hits(v, r, lane);
  __shared__ int part[kWarps];
  const int s = block_sum(n, part);
  if (threadIdx.x == 0) {
    block_counts[L.gblock0 + k] = s;
    if (s) atomicAdd(total + seg, s);
    if (chunk == 0) seg_cap[seg] = L.capacity;
  }
}

__global__ void __launch_bounds__(kThreads) emit_kernel(
    const Sift3dExtremaTable t, float peak,
    const unsigned* __restrict__ dogmax,
    const int* __restrict__ block_counts,
    const long long* __restrict__ before,
    const long long* __restrict__ out_start, int4* __restrict__ rows) {
  const int l = level_of(t, blockIdx.x, false);
  const Sift3dExtremaLevel& L = t.lv[l];
  const int k = blockIdx.x - L.block0;
  const long long gb = L.gblock0 + k;
  if (block_counts[gb] == 0) return;
  const int b = k / L.chunks, chunk = k - b * L.chunks;
  // Rank in the volume of the block's first row: the hits of the volume's
  // blocks before it.
  int base = static_cast<int>(
      before[gb] - before[L.gblock0 + static_cast<long long>(b) * L.chunks]);
  const int cap = L.capacity;
  if (base >= cap) return;
  const int seg = L.seg0 + b;
  const View v = view_of(L, b, threshold(peak, dogmax, seg));
  int4* out = rows + out_start[seg];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int r1 = min((chunk + 1) * L.rows_per_block, L.rows);
  __shared__ int part[kWarps];
  // Rows r0 + warp of each step, the warps' rows in order.
  for (int r0 = chunk * L.rows_per_block; r0 < r1 && base < cap;
       r0 += kWarps) {
    const int r = r0 + warp;
    const int n = r < r1 ? row_hits(v, r, lane) : 0;
    if (lane == 0) part[warp] = n;
    __syncthreads();
    int rank = base, step = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rank += w < warp ? part[w] : 0;
      step += part[w];
    }
    __syncthreads();
    if (n > 0 && rank < cap) {
      int z, y;
      const int row = row_offset(v, r, &z, &y);
      for (int x0 = 0; x0 < v.NX && rank < cap; x0 += 32 * kUnroll) {
        unsigned m[kUnroll];
        ballots(v, row, x0, lane, m);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if ((m[u] >> lane) & 1u) {
            const int q = rank + __popc(m[u] & below);
            if (q < cap) out[q] = make_int4(b, z + 1, y + 1, x0 + 32 * u +
                                                                 lane + 1);
          }
          rank += __popc(m[u]);
        }
      }
    }
    base += step;
  }
}

Sift3dExtremaTable make_table(const Sift3dExtremaLevel* levels,
                              int num_levels) {
  Sift3dExtremaTable t;
  for (int i = 0; i < num_levels; ++i) t.lv[i] = levels[i];
  t.num_levels = num_levels;
  return t;
}

bool bad_levels(int num_levels) {
  return num_levels > kMaxLevels || num_levels < 0;
}

}  // namespace

// The three passes over `num_levels` levels (a host array of
// Sift3dExtremaLevel, block0 and max_block0 ascending), `num_blocks` blocks
// each (the max pass its own count). Per-(level, volume) arrays are
// indexed by seg0 + volume: dogmax (the bits of max |cur|, zeroed before
// the max pass), total (zeroed; the unclamped hit counts) and seg_cap
// (zeroed; the capacity). block_counts holds each count block's hits;
// before their exclusive prefix over the call, out_start each (level,
// volume)'s first row in `rows` ((sum of the clamped counts, 4) int32).
// Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for more than kMaxLevels levels.
extern "C" int sift3d_extrema_max(const Sift3dExtremaLevel* levels,
                                  int num_levels, int num_blocks,
                                  unsigned* dogmax, void* stream) {
  if (bad_levels(num_levels)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return 0;
  max_kernel<<<num_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_table(levels, num_levels), dogmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sift3d_extrema_count(const Sift3dExtremaLevel* levels,
                                    int num_levels, int num_blocks,
                                    float peak, const unsigned* dogmax,
                                    int* total, int* seg_cap,
                                    int* block_counts, void* stream) {
  if (bad_levels(num_levels)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return 0;
  count_kernel<<<num_blocks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      make_table(levels, num_levels), peak, dogmax, total, seg_cap,
      block_counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sift3d_extrema_emit(const Sift3dExtremaLevel* levels,
                                   int num_levels, int num_blocks,
                                   float peak, const unsigned* dogmax,
                                   const int* block_counts,
                                   const long long* before,
                                   const long long* out_start, int* rows,
                                   void* stream) {
  if (bad_levels(num_levels)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return 0;
  emit_kernel<<<num_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_table(levels, num_levels), peak, dogmax, block_counts, before,
      out_start, reinterpret_cast<int4*>(rows));
  return static_cast<int>(cudaGetLastError());
}
