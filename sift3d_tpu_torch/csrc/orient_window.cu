// SIFT3D orientation window kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_orient_kernel_body` of
// sift3d_tpu/ops/pallas_orient.py (launched by `_orient_pallas_call`). For
// each keypoint row below its level's `count` it takes the nine
// Gaussian-weighted sums of the orientation structure tensor (reference
// assign_eig_ori, sift3d/sift.c:1354-1426) over the row's clamped core
// window of one Gaussian pyramid level:
//   - core starts clip(c - R, 1, n - 1 - core) per axis, c the row's
//     integer centre (features/windows.window_starts);
//   - per voxel: offset d = voxel - c, v = d * units; the voxel counts when
//     |d| <= R on each axis and |v|^2 <= rad^2; weight
//     w = exp(-0.5 |v|^2 / sigma^2);
//   - unit-corrected central differences g = 0.5 (I[+1] - I[-1]) / u;
//   - six sums w gi gj (xx, xy, xz, yy, yz, zz) and three sums w gi (the
//     window gradient, written as fp32), all in float64.
// Rows at or past their level's `count` are written as zeros. One launch
// covers the rows of every level of a detection and every volume of a
// batch: row k reads volume rows[4k] of its (B, nz, ny, nx) level.
//
// What bounded the first design (one launch per level, one 256-thread
// block per row striding over the whole core box): launches, 17 per
// 256^3 volume, each a grid of a few dozen blocks; two integer divisions
// and the sphere test on every box voxel, half of which fail it (and at
// 6^3 cores 40 of the 256 threads had no voxel at all); and per counted
// voxel an IEEE division, an expf, seven fp32 -> fp64 conversions (a
// quarter of the fp64 FMA rate on sm_90) and 21 unfused fp64 operations.
//
// Design now:
//   - One launch for all levels. Each level's geometry, table and row range
//     come by value in a table of up to kMaxLevels entries (the wrapper
//     launches once per kMaxLevels levels with rows); a block belongs to
//     one level and finds it by a scan of the table's first blocks.
//   - The weights depend only on the offset d, so the wrapper builds once
//     per level geometry (and caches) the list of offsets inside the
//     sphere, |d| <= min(R, core - 1) per axis, in (dz, dy, dx) order, each
//     with its level offset and its weight as float64. The wrapper forms
//     |v|^2, the mask and w with the plain version's own torch operations,
//     so mask and weights are bitwise the plain version's on the card. A
//     lane walks that list 32 entries apart: no voxel outside the sphere is
//     visited, and consecutive lanes read consecutive x. A row whose core
//     does not hold the whole list (a window clamped at the level's edge)
//     also tests each entry against its core.
//   - A row's list is split over 1-8 warps of one block (interleaved 32-entry
//     chunks; more warps for longer lists); a block holds 8 / warps rows of
//     one level. Each warp reduces its sums by shuffles, and the block adds
//     its warps' partial sums in warp order: the result does not depend on
//     scheduling, so two launches give equal bits.
//   - Per counted voxel: one 16-byte table load (two entries' loads in
//     flight at once for unclamped rows), six level loads (L1 / L2:
//     neighbouring voxels share them), nine fp32 operations for g, three
//     fp32 -> fp64 conversions, six exact fp64 products gi gj and nine fp64
//     FMAs fma(gi gj, w, s) / fma(gi, w, s): one rounding per term instead
//     of three (within 1e-5 of the plain version's row maximum).
//
//   - A level whose table the 10-bit packing cannot hold (an extent above
//     511) or whose table would be read from device memory rather than the
//     caches (more than ops/cuda_orient.BOX_WALK_ENTRIES offsets in its
//     box: the raw-image path's windows from octave 4 on, where this walk
//     is faster) has no table: each row
//     walks its core box cut to |d| <= R, 32 voxels apart per lane in the
//     same interleaved chunks, and forms |v|^2, the sphere test and the
//     weight per voxel with the plain version's operations on the card
//     (unfused fp32 products and sums, exp of (-0.5 |v|^2) * fl(1 /
//     sigma^2), as torch's division by a scalar does). No window is
//     clamped, so the sums are the plain version's to its tolerance.
//
// What bounds it on the H100: neither device memory nor the fp64 rate
// (ops/cuda_orient.orient_work counts both).
// A voxel costs about 1.4 SM cycles against 0.65 to issue its 83
// instructions, and more resident rows per SM (5 or 6 blocks) make it
// slower: the six level loads per voxel, served by L1 while a row's
// window stays resident there, are the likely limit. Staging the table in
// shared memory, which takes L1's capacity, was slower too.

#include <cuda_runtime.h>

constexpr int kMaxLevels = 32;

// One level of a launch; mirrored by `_Level` in ops/cuda_orient.py. At
// namespace scope, since the C entry point takes an array of it.
struct Sift3dOrientLevel {
  const float* level;   // (B, nz, ny, nx)
  const int4* table;    // {level offset, packed d (10 bits an axis,
                        // biased by 512), w as f64 (lo, hi)}; null: the
                        // rows walk their core boxes
  int nz, ny, nx;
  int cz, cy, cx;       // clamped core extents
  int rz, ry, rx;       // window half-extents
  int ez, ey, ex;       // the table's extents: |d| <= e per axis
  int entries;          // table length
  int log2_warps;       // warps per row = 1 << log2_warps
  int row0, rows, count;  // rows [row0, row0 + rows); real below count
  int block0;           // first block of the level
  float inv_ux, inv_uy, inv_uz;  // 1 / spacing, rounded in fp32
  float ux, uy, uz;     // spacing (the box walk's |v|^2)
  float rad2;           // window radius^2
  float w_scale;        // 1 / sigma^2, rounded in fp32
};

struct Sift3dOrientTable {
  Sift3dOrientLevel lv[kMaxLevels];
  int num_levels;
};
static_assert(sizeof(Sift3dOrientTable) + 3 * sizeof(void*) <= 4096,
              "kernel parameters must fit in 4 KB");

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 9;

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 0.5 * (hi - lo) * inv, in that order, unfused.
__device__ __forceinline__ float central(float hi, float lo, float inv) {
  return __fmul_rn(__fmul_rn(0.5f, __fsub_rn(hi, lo)), inv);
}

// lo <= v <= hi.
__device__ __forceinline__ bool within(int v, int lo, int hi) {
  return static_cast<unsigned>(v - lo) <= static_cast<unsigned>(hi - lo);
}

// One row's window as the walk sees it.
struct Row {
  const float* c;       // the centre voxel
  int nx, plane;        // level strides (elements)
  int lz, hz, ly, hy, lx, hx;  // the core's offsets from the centre
  float inv_ux, inv_uy, inv_uz;
};

// Adds the voxel at level offset `off` from the centre, weight w, to the
// nine sums.
__device__ __forceinline__ void accumulate(const Row& r, long long off,
                                           double w, double* s) {
  const float* v = r.c + off;
  const float gx = central(__ldg(v + 1), __ldg(v - 1), r.inv_ux);
  const float gy = central(__ldg(v + r.nx), __ldg(v - r.nx), r.inv_uy);
  const float gz = central(__ldg(v + r.plane), __ldg(v - r.plane), r.inv_uz);
  const double X = gx, Y = gy, Z = gz;
  // gi * gj of two fp32 values is exact in fp64.
  s[0] = __fma_rn(__dmul_rn(X, X), w, s[0]);
  s[1] = __fma_rn(__dmul_rn(X, Y), w, s[1]);
  s[2] = __fma_rn(__dmul_rn(X, Z), w, s[2]);
  s[3] = __fma_rn(__dmul_rn(Y, Y), w, s[3]);
  s[4] = __fma_rn(__dmul_rn(Y, Z), w, s[4]);
  s[5] = __fma_rn(__dmul_rn(Z, Z), w, s[5]);
  s[6] = __fma_rn(X, w, s[6]);
  s[7] = __fma_rn(Y, w, s[7]);
  s[8] = __fma_rn(Z, w, s[8]);
}

// Adds table entry q (level offset, packed d, w) to the nine sums.
__device__ __forceinline__ void accumulate(const Row& r, int4 q,
                                           double* s) {
  accumulate(r, q.x, __hiloint2double(q.w, q.z), s);
}

// Entries e, e + step, ... of the table, in that order. A row whose core
// holds the whole table takes two entries an iteration (their loads in
// flight together); a clamped row tests each entry against its core.
template <bool kFull>
__device__ __forceinline__ void walk(const Row& r, const int4* table,
                                     int entries, int e, int step,
                                     double* s) {
  if (kFull) {
    for (; e + step < entries; e += 2 * step) {
      const int4 q0 = __ldg(table + e), q1 = __ldg(table + e + step);
      accumulate(r, q0, s);
      accumulate(r, q1, s);
    }
    if (e < entries) accumulate(r, __ldg(table + e), s);
  } else {
    for (; e < entries; e += step) {
      const int4 q = __ldg(table + e);
      const int dz = ((q.y >> 20) & 0x3ff) - 512;
      const int dy = ((q.y >> 10) & 0x3ff) - 512;
      const int dx = (q.y & 0x3ff) - 512;
      if (within(dz, r.lz, r.hz) && within(dy, r.ly, r.hy) &&
          within(dx, r.lx, r.hx))
        accumulate(r, q, s);
    }
  }
}

// A row with no table: voxels e, e + step, ... of its core box cut to
// |d| <= R (offsets [lo, lo + n) per axis, x fastest), each tested against
// the sphere and weighted here. The linear index is carried as mixed-radix
// digits, so a step costs no division.
__device__ __forceinline__ void walk_box(const Row& r,
                                         const Sift3dOrientLevel& L, int e,
                                         int step, double* s) {
  const int lz = max(r.lz, -L.rz), ly = max(r.ly, -L.ry),
            lx = max(r.lx, -L.rx);
  const int nz = min(r.hz, L.rz) - lz + 1, ny = min(r.hy, L.ry) - ly + 1,
            nx = min(r.hx, L.rx) - lx + 1;
  if (nz <= 0 || ny <= 0 || nx <= 0) return;
  int x = e % nx, y = e / nx % ny, z = e / nx / ny;
  const int sx = step % nx, sy = step / nx % ny, sz = step / nx / ny;
  while (z < nz) {
    const int dz = lz + z, dy = ly + y, dx = lx + x;
    const float vx = __fmul_rn(static_cast<float>(dx), L.ux);
    const float vy = __fmul_rn(static_cast<float>(dy), L.uy);
    const float vz = __fmul_rn(static_cast<float>(dz), L.uz);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                               __fmul_rn(vz, vz));
    if (sq <= L.rad2) {
      const float w = expf(__fmul_rn(__fmul_rn(-0.5f, sq), L.w_scale));
      accumulate(r, static_cast<long long>(dz) * r.plane +
                        static_cast<long long>(dy) * r.nx + dx,
                 static_cast<double>(w), s);
    }
    x += sx;
    int carry = 0;
    if (x >= nx) {
      x -= nx;
      carry = 1;
    }
    y += sy + carry;
    if (y >= ny) {
      y -= ny;
      ++z;
    }
    z += sz;
  }
}

// At most 64 registers a thread, so that 4 blocks fit an SM as before the
// box walk (which took the kernel to 74 registers and 3 blocks an SM).
__global__ void __launch_bounds__(kThreads, 4) orient_levels_kernel(
    const Sift3dOrientTable t, const int* __restrict__ rows,
    double* __restrict__ a6, float* __restrict__ vd) {
  int l = 0;
  while (l + 1 < t.num_levels &&
         static_cast<int>(blockIdx.x) >= t.lv[l + 1].block0)
    ++l;
  const Sift3dOrientLevel& L = t.lv[l];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lw = L.log2_warps;
  const int per_block = kWarps >> lw;
  const int first = (blockIdx.x - L.block0) * per_block;
  const int k = first + (warp >> lw);
  const int piece = warp & ((1 << lw) - 1);

  double s[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) s[i] = 0.0;

  if (k < L.count) {
    const int* rw = rows + 4 * (L.row0 + k);
    const int b = rw[0], z0 = rw[1], y0 = rw[2], x0 = rw[3];
    const int sz = clip(z0 - L.rz, 1, L.nz - 1 - L.cz);
    const int sy = clip(y0 - L.ry, 1, L.ny - 1 - L.cy);
    const int sx = clip(x0 - L.rx, 1, L.nx - 1 - L.cx);
    Row r;
    r.nx = L.nx;
    r.plane = L.ny * L.nx;
    r.c = L.level + static_cast<size_t>(b) * L.nz * r.plane +
          (static_cast<size_t>(z0) * L.ny + y0) * L.nx + x0;
    r.lz = sz - z0, r.hz = r.lz + L.cz - 1;
    r.ly = sy - y0, r.hy = r.ly + L.cy - 1;
    r.lx = sx - x0, r.hx = r.lx + L.cx - 1;
    r.inv_ux = L.inv_ux, r.inv_uy = L.inv_uy, r.inv_uz = L.inv_uz;
    const bool full = r.lz <= -L.ez && r.hz >= L.ez && r.ly <= -L.ey &&
                      r.hy >= L.ey && r.lx <= -L.ex && r.hx >= L.ex;
    const int e = (piece << 5) + lane, step = 32 << lw;
    if (L.table == nullptr) walk_box(r, L, e, step, s);
    else if (full) walk<true>(r, L.table, L.entries, e, step, s);
    else walk<false>(r, L.table, L.entries, e, step, s);
  }

#pragma unroll
  for (int i = 0; i < kSums; ++i)
    for (int off = 16; off > 0; off >>= 1)
      s[i] += __shfl_down_sync(0xffffffffu, s[i], off);
  __shared__ double part[kWarps][kSums];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) part[warp][i] = s[i];
  }
  __syncthreads();
  // Each row's warps added in warp order.
  for (int j = threadIdx.x; j < per_block * kSums; j += kThreads) {
    const int rl = j / kSums, i = j - rl * kSums;
    const int kk = first + rl;
    if (kk >= L.rows) continue;
    double sum = 0.0;
    if (kk < L.count)
      for (int p = 0; p < (1 << lw); ++p) sum += part[(rl << lw) + p][i];
    const int row = L.row0 + kk;
    if (i < 6) a6[6 * row + i] = sum;
    else vd[3 * row + i - 6] = static_cast<float>(sum);
  }
}

}  // namespace

// Structure-tensor sums of the rows of `num_levels` levels in one launch.
// levels: host array of Sift3dOrientLevel (row ranges consecutive, block0
// ascending); rows (sum of rows, 4) i32 (volume, z, y, x); a6 (rows, 6)
// f64 and vd (rows, 3) f32 outputs; num_blocks the grid. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for more
// than kMaxLevels levels.
extern "C" int sift3d_orient_levels(const Sift3dOrientLevel* levels,
                                    int num_levels, int num_blocks,
                                    const int* rows, double* a6, float* vd,
                                    void* stream) {
  if (num_levels > kMaxLevels || num_levels < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return 0;
  Sift3dOrientTable t;
  for (int i = 0; i < num_levels; ++i) t.lv[i] = levels[i];
  t.num_levels = num_levels;
  orient_levels_kernel<<<num_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(t, rows, a6,
                                                              vd);
  return static_cast<int>(cudaGetLastError());
}
