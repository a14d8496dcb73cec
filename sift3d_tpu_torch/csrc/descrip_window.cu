// SIFT3D descriptor window kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_descrip_kernel_body` of
// sift3d_tpu/ops/pallas_window.py (launched by `_descrip_pallas_call`). For
// each keypoint row below `count` it builds the raw 4x4x4 x 12-bin
// icosahedral gradient histogram (reference extract_descrip and
// SIFT3D_desc_acc_interp, sift3d/sift.c:1687-1928) over the clamped core
// window of one Gaussian pyramid level:
//   - displacement v from the keypoint centre in mm, kept inside the sphere
//     |v| <= rad and rotated by R^T into the keypoint frame; voxels whose
//     rotated bin coordinates fall outside [0, 4)^3 add nothing;
//   - unit-corrected central-difference gradient, weighted by
//     exp(-|v|^2 / 2 sigma^2) and rotated by R^T;
//   - icosahedral face = argmax over the 20 outward unit normals (strict >
//     scan, so ties go to the lowest face index); barycentric weights from
//     the per-face inverse vertex matrix, divided by their sum; the voxel is
//     dropped if the sum is <= 0 or |g|^2 < BARY_EPS;
//   - trilinear hat weights over the 4^3 spatial grid; |g| * bary * hat goes
//     into bin el = ((hz*4 + hy)*4 + hx)*12 + vertex.
// Rows at or past `count` are written as zeros. Rows may come from
// different volumes of a batch: row k reads volume vol[k] of a
// (B, nz, ny, nx) level (the TPU version's custom_vmap flattens the (B, K)
// rows of a batch into one grid in the same way). The kernel computes each
// row's clamped core start itself and reads the window in place (no
// stacked per-keypoint window copy in device memory).
//
// What bounded the first design: one block per keypoint row, so a level
// bucket of 1-25 rows (a 256^3 registration) kept at most 25 of the 132
// SMs busy; each voxel did 24 float atomicAdds on one shared 768-float
// histogram, which sm_90 runs as compare-and-swap loops (ATOMS.CAST.SPIN)
// that serialize when the lanes of a warp hit the same bin, as the 32
// consecutive voxels of one window line mostly did; and every thread
// walked the whole box with a division and a modulo per voxel, idling on
// the voxels outside the sphere and the rotated bin cube (70% of the box).
//
// Design now:
//   - The grid is rows x z-slabs. The wrapper picks the slab depth from the
//     row count and the core depth so that the grid holds at least 2 x 132
//     blocks where rows x planes allow it; a bucket that fills the card
//     (the batch) takes one slab per row. With several slabs each block
//     writes a partial histogram to scratch (blocks x 768 floats) and a
//     second pass sums a row's slabs in slab order.
//   - A block takes its slab's (z, y) lines 256 at a time: each thread cuts
//     one line to its x-span inside the sphere and the rotated bin cube
//     (one voxel of margin; the exact unfused fp32 sphere and bin-cube
//     tests still run per voxel, so the masks agree with the plain version
//     voxel for voxel), and a block prefix sum of the span lengths lays
//     the candidate voxels out densely. Lane l of a warp takes candidates
//     q apart, so lanes work on different lines and mostly different bins,
//     and no lane idles on a voxel outside the cut.
//   - Each bin update is a native shared-memory integer atomicAdd
//     (ATOMS.ADD) of the contribution in fixed point, into a private
//     histogram per warp. (Lanes that hit the same bin first combining
//     their values, then one atomic on a single histogram per block, was
//     measured and is several times slower.)
//     The scale is a power of two from the range (max - min) of the values
//     the block's gradients read (its slab of the window with the halo),
//     such that a pass of 2048 candidates cannot overflow; after each pass
//     the integer sums fold into a float histogram. Each contribution is
//     rounded to a step of 2^-21 to 2^-22 of the largest gradient the
//     slab could hold, so the error follows the window's own contrast,
//     not the level's; the integer sums are exact and order-free. A voxel
//     whose rotated gradient is under 2^8 steps adds its contributions
//     instead to a fine histogram (one per pair of warps) at a step 2^13
//     times finer: where a slab holds a bright structure and many dark
//     voxels (a whole-volume window of the raw-image path), the dark
//     voxels' contributions would otherwise round to nothing, and the bins
//     they alone fill lost 4% of their mass (card test at 128^3 and 256^3,
//     contrast 10^4). The choice is made once a voxel: a test for each
//     contribution cost a fifth more kernel time in the config-4 batch,
//     and with one fine histogram a block a third. This is
//     the one place the kernel leaves fp32 (the card tests of a dark
//     window inside a bright level hold it to the descriptor tolerance). The
//     range comes from a first pass that takes the min and max of each
//     8^3 tile of the level (the level read once); a block reduces the
//     few tiles that cover its slab. (Each block scanning its own slab
//     instead read every window in full, 9 times the union of the windows
//     in the config-4 batch, and cost a third more kernel time there.)
//   - The face scan takes its normals from the kernel's parameters,
//     computes 10 dot products (the other 10 faces are their antipodes)
//     and finds the first argmax as a tree over index-ordered halves (the
//     strict > scan's result: ties go to the lowest face).
//   - A line's y and z go to shared memory as they are (an earlier
//     packing of both in one int, 10 bits for y and 11 for z, refused cores
//     above 1024 voxels; a 1100 x 512 x 512 volume's raw-image windows
//     reach a 1098-voxel z core), so a core may take any extent. The
//     kernel's shared-memory carveout holds at most 4 blocks an SM
//     (kBlocksPerSm).
//   - Everything else stays fp32, in the first design's order, except
//     that the three barycentric weights share one division (b_i *
//     (|g| / sum) in place of b_i / sum * |g|).
//
// What bounds it now: fp32 instruction throughput in the per-voxel
// arithmetic (216 operations per voxel that adds to the histogram, as
// ops/cuda_window.py counts them), with the line scan, the tile-range pass
// and the shared atomics behind it; device memory is not the limit (the
// windows are read mostly from L1 and L2). At the 256^3 registration's
// small buckets the host's launch overhead is of the same order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFaces = 20;
constexpr int kHist = 768;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 2048;   // candidate voxels between fixed-point folds
constexpr int kTile = 8;      // edge of the tiles of the range pass
constexpr float kRound = 12582912.0f;     // 1.5 * 2^23
// A voxel whose rotated gradient is below kFineBelow steps of the block's
// scale adds its contributions to a fine fixed-point histogram (one per
// pair of warps), kFineGain times finer: kFineBelow * kFineGain = 2^21.
constexpr float kFineBelow = 256.0f;      // 2^8
constexpr float kFineGain = 8192.0f;      // 2^13
constexpr float kBinEps = 1e-3f;          // bin-cube margin of a line's span
constexpr float kFlat = 1e-6f;            // |d k / d x| below which a line
                                          // runs parallel to a cube face
// Blocks that share an SM. The launcher sets the kernel's shared-memory
// carveout (``set_carveout``) to the least that holds this many blocks, so
// L1 keeps the rest for the window reads. Left to the driver, the kernel's
// 48 registers and 45,092 B let a fifth block in and leave L1 about 28 KB:
// 14.79-15.20 ms per config-4 batch against 12.42-12.52 with 4 blocks
// (scripts/descrip_ab.py, NVIDIA H100 80GB HBM3, 700 W).
constexpr int kBlocksPerSm = 4;

struct Params {
  float ux, uy, uz;              // voxel spacing (mm)
  float inv_ux, inv_uy, inv_uz;  // 1 / spacing, rounded in fp32
  float rad2;                    // window radius^2 (mm^2)
  float sig2;                    // Gaussian sigma^2 (mm^2)
  float half_width;              // rad / sqrt(2)
  float bin_fctr;                // 1 / (2 * half_width / 4)
  float bary_eps;                // BARY_EPS
};

// Hat weights of one bin coordinate vb in [0, 4): bin lo gets 1 - fr and
// bin lo + 1 (when < 4) gets fr.
__device__ __forceinline__ void hat(float vb, int* lo, float* w0, float* w1) {
  const float f = floorf(vb);
  const float fr = vb - f;
  *lo = static_cast<int>(f);
  *w0 = 1.0f - fr;
  *w1 = fr;
}

// Clamped core start of one axis: clip(floor(c) - r, 1, n - 1 - core).
__device__ __forceinline__ int core_start(float c, int r, int n, int core) {
  return min(max(static_cast<int>(floorf(c)) - r, 1), n - 1 - core);
}

// One row's keypoint frame: centre (level voxels) and R row-major; the
// kernel applies R^T: (R^T u)_i = sum_j R[j][i] u_j.
struct Frame {
  float cx, cy, cz;
  float r0, r1, r2, r3, r4, r5, r6, r7, r8;
};

// |v|^2 (v the displacement in mm) and rotated bin coordinates of voxel
// (x, y, z)
// in unfused IEEE fp32, the plain version's rounding, so the sphere and
// bin-cube masks agree voxel for voxel. True when the voxel lies in the
// sphere and the bin cube.
__device__ __forceinline__ bool voxel_frame(const Params& p, const Frame& f,
                                            int x, int y, int z, float* sq,
                                            float* vb) {
  const float vx = __fmul_rn(__fsub_rn(static_cast<float>(x), f.cx), p.ux);
  const float vy = __fmul_rn(__fsub_rn(static_cast<float>(y), f.cy), p.uy);
  const float vz = __fmul_rn(__fsub_rn(static_cast<float>(z), f.cz), p.uz);
  *sq = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                  __fmul_rn(vz, vz));
  if (!(*sq <= p.rad2)) return false;
  const float kx = __fadd_rn(
      __fadd_rn(__fmul_rn(f.r0, vx), __fmul_rn(f.r3, vy)), __fmul_rn(f.r6, vz));
  const float ky = __fadd_rn(
      __fadd_rn(__fmul_rn(f.r1, vx), __fmul_rn(f.r4, vy)), __fmul_rn(f.r7, vz));
  const float kz = __fadd_rn(
      __fadd_rn(__fmul_rn(f.r2, vx), __fmul_rn(f.r5, vy)), __fmul_rn(f.r8, vz));
  vb[0] = __fmul_rn(__fadd_rn(kx, p.half_width), p.bin_fctr);
  vb[1] = __fmul_rn(__fadd_rn(ky, p.half_width), p.bin_fctr);
  vb[2] = __fmul_rn(__fadd_rn(kz, p.half_width), p.bin_fctr);
  return vb[0] >= 0.0f && vb[1] >= 0.0f && vb[2] >= 0.0f && vb[0] < 4.0f &&
         vb[1] < 4.0f && vb[2] < 4.0f;
}

// Conservative x-span [x_lo, x_hi] of the core line (y, z): every voxel of
// the line that lies in the sphere and the rotated bin cube lies in it
// (both cuts widened by one voxel; the exact tests still run per voxel).
// vy, vz are the line's displacements (mm). Empty when x_lo > x_hi.
__device__ __forceinline__ void line_span(const Params& p, const Frame& f,
                                          float vy, float vz, int sx, int cx,
                                          int* x_lo, int* x_hi) {
  // |v|^2 = (vx^2 + vy^2) + vz^2 rounds to at least vy^2 + vz^2, so a line
  // past the radius holds no voxel of the sphere.
  const float yz = __fadd_rn(__fmul_rn(vy, vy), __fmul_rn(vz, vz));
  *x_lo = sx;
  *x_hi = yz <= p.rad2 ? sx + cx - 1 : sx - 1;
  if (*x_lo > *x_hi) return;
  const float half = __fmul_rn(sqrtf(__fsub_rn(p.rad2, yz)), p.inv_ux);
  float t_lo = -half, t_hi = half;   // x - cx, in voxels
  // Bin coordinate i along the line: (a_i + b_i t + hw) * bin_fctr with
  // b_i = R[0][i] ux; keep it inside [-eps, 4 + eps].
  const float rx[3] = {f.r0, f.r1, f.r2}, ry[3] = {f.r3, f.r4, f.r5},
              rz[3] = {f.r6, f.r7, f.r8};
  const float k_lo = -kBinEps / p.bin_fctr - p.half_width;
  const float k_hi = (4.0f + kBinEps) / p.bin_fctr - p.half_width;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a = ry[i] * vy + rz[i] * vz;
    const float b = rx[i] * p.ux;
    if (fabsf(b) > kFlat) {
      float t0 = (k_lo - a) / b, t1 = (k_hi - a) / b;
      if (b < 0.0f) {
        const float tmp = t0;
        t0 = t1;
        t1 = tmp;
      }
      t_lo = fmaxf(t_lo, t0);
      t_hi = fminf(t_hi, t1);
    } else if (!(a >= k_lo && a <= k_hi)) {
      t_hi = -2.0f * half - 4.0f;   // the line misses the bin cube
    }
  }
  *x_lo = max(sx, static_cast<int>(ceilf(f.cx + t_lo)) - 1);
  *x_hi = min(sx + cx - 1, static_cast<int>(floorf(f.cx + t_hi)) + 1);
}

// The icosahedron's outward unit normals, passed by value (the kernel
// reads them from its parameter space with constant indices).
struct Normals {
  float n[kFaces * 3];
};

// Face 10 + i's normal is exactly minus face antipode(i)'s (the entry
// point checks it), so its dot product is the exact negation.
__host__ __device__ constexpr int antipode(int i) {
  constexpr int a[10] = {5, 6, 7, 8, 9, 2, 1, 0, 4, 3};
  return a[i];
}

// Face of the rotated gradient: the first argmax over the 20 normals of
// the dot product, as a strict > scan in face order finds it, taken as a
// tree over index-ordered halves (the higher-index side wins only when
// strictly greater), so the products are independent.
__device__ __forceinline__ int best_face(const Normals& c, float gx,
                                         float gy, float gz) {
  float v[kFaces];
  int id[kFaces];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    v[i] = c.n[3 * i] * gx + c.n[3 * i + 1] * gy + c.n[3 * i + 2] * gz;
    id[i] = i;
    id[10 + i] = 10 + i;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) v[10 + i] = -v[antipode(i)];
#pragma unroll
  for (int w = 1; w < kFaces; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kFaces; i += 2 * w) {
      const bool right = v[i + w] > v[i];
      v[i] = right ? v[i + w] : v[i];
      id[i] = right ? id[i + w] : id[i];
    }
  }
  return id[0];
}

// Gradient, face, barycentric and hat weights of one voxel that passed
// the geometry tests, added into histogram h at `scale`, or into `fine`
// at `fine_scale` when its gradient is under kFineBelow steps.
__device__ __forceinline__ void accumulate(
    const Params& p, const Frame& f, const float* __restrict__ lv,
    size_t c, size_t lplane, int nx, float sq, const float* vb,
    float scale, float fine_scale, const Normals& nrm, const float* s_vinv,
    const int* s_vert, int* h, int* fine) {
  const float w = expf(-0.5f * sq / p.sig2);
  const float gx = 0.5f * (lv[c + 1] - lv[c - 1]) * p.inv_ux * w;
  const float gy = 0.5f * (lv[c + nx] - lv[c - nx]) * p.inv_uy * w;
  const float gz = 0.5f * (lv[c + lplane] - lv[c - lplane]) * p.inv_uz * w;
  const float grx = f.r0 * gx + f.r3 * gy + f.r6 * gz;
  const float gry = f.r1 * gx + f.r4 * gy + f.r7 * gz;
  const float grz = f.r2 * gx + f.r5 * gy + f.r8 * gz;
  const float mag2 = grx * grx + gry * gry + grz * grz;
  if (!(mag2 >= p.bary_eps)) return;

  const int face = best_face(nrm, grx, gry, grz);
  const float* m = s_vinv + 9 * face;
  const float b0 = m[0] * grx + m[1] * gry + m[2] * grz;
  const float b1 = m[3] * grx + m[4] * gry + m[5] * grz;
  const float b2 = m[6] * grx + m[7] * gry + m[8] * grz;
  const float bsum = b0 + b1 + b2;
  if (!(bsum > 0.0f)) return;
  const float mag = sqrtf(mag2);
  const float ib = mag / bsum;
  const float val[3] = {b0 * ib, b1 * ib, b2 * ib};
  const int* vert = s_vert + 3 * face;

  // Every contribution is at most |g| (bary and hat weights <= 1): a voxel
  // under kFineBelow steps goes whole to the fine histogram.
  const bool small = mag * scale < kFineBelow;
  const float s = small ? fine_scale : scale;
  int* const hh = small ? fine : h;

  int lz, ly, lx;
  float wz[2], wy[2], wx[2];
  hat(vb[2], &lz, &wz[0], &wz[1]);
  hat(vb[1], &ly, &wy[0], &wy[1]);
  hat(vb[0], &lx, &wx[0], &wx[1]);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int hz = lz + a;
    if (hz >= 4) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int hy = ly + b;
      if (hy >= 4) continue;
      const float wzy = wz[a] * wy[b];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int hx = lx + d;
        if (hx >= 4) continue;
        const float sw = wzy * wx[d] * s;
        const int cell = ((hz * 4 + hy) * 4 + hx) * 12;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          // round(sw * val) as an int: adding 1.5 * 2^23 leaves the
          // rounded integer in the low mantissa bits (|sw * val| < 2^22).
          const float q = __fmaf_rn(sw, val[t], kRound);
          atomicAdd(hh + cell + vert[t],
                    __float_as_int(q) - __float_as_int(kRound));
        }
      }
    }
  }
}

// Min and max of each kTile^3 tile of a (B, nz, ny, nx) level, into range
// (B, tz, ty, tx) as (min, max): a warp per tile, lanes on 4 lines of 8.
__global__ void __launch_bounds__(kThreads) tile_range_kernel(
    const float* __restrict__ level, int nz, int ny, int nx, int tz, int ty,
    int tx, long long tiles, float2* __restrict__ range) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;
  const int lane = threadIdx.x & 31;
  const int ix = static_cast<int>(t % tx);
  const int iy = static_cast<int>(t / tx % ty);
  const int iz = static_cast<int>(t / tx / ty % tz);
  const float* lv = level + t / tx / ty / tz * nz * ny * nx;
  const int x = ix * kTile + (lane & 7);
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTile * kTile / 4; ++j) {
    const int y = iy * kTile + (j & 1) * 4 + (lane >> 3);
    const int z = iz * kTile + (j >> 1);
    if (x < nx && y < ny && z < nz) {
      const float v = lv[(static_cast<size_t>(z) * ny + y) * nx + x];
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) range[t] = make_float2(lo, hi);
}

__global__ void __launch_bounds__(kThreads) descrip_window_kernel(
    const float* __restrict__ level, int nz, int ny, int nx,
    const int* __restrict__ vol, const float* __restrict__ centers,
    const float* __restrict__ rot, int rz, int ry, int rx, int cz, int cy,
    int cx, int planes, Params p, Normals nrm,
    const float* __restrict__ tables, const int* __restrict__ face_idx,
    const float2* __restrict__ range, float* __restrict__ out) {
  __shared__ int ihist[kWarps * kHist];   // this pass's fixed-point sums
  __shared__ int fine[kWarps / 2 * kHist];  // its small voxels' sums
  __shared__ float hist[kHist];
  __shared__ float s_vinv[kFaces * 9];
  __shared__ int s_vert[kFaces * 3];
  __shared__ int l_off[kThreads + 1];   // a round's lines: span offsets,
  __shared__ int l_x0[kThreads];        // first x, y and z
  __shared__ int l_y[kThreads];
  __shared__ int l_z[kThreads];
  __shared__ int warp_sum[kWarps];
  __shared__ float warp_lo[kWarps], warp_hi[kWarps];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * kHist; i += kThreads) ihist[i] = 0;
  for (int i = tid; i < kWarps / 2 * kHist; i += kThreads) fine[i] = 0;
  for (int i = tid; i < kHist; i += kThreads) hist[i] = 0.0f;
  for (int i = tid; i < kFaces * 3; i += kThreads) {
    s_vert[i] = face_idx[i];
  }
  for (int i = tid; i < kFaces * 9; i += kThreads)
    s_vinv[i] = tables[kFaces * 3 + i];
  __syncthreads();

  const float* r = rot + 9 * k;
  const Frame f{centers[3 * k + 2], centers[3 * k + 1], centers[3 * k],
                r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]};
  const int sz = core_start(f.cz, rz, nz, cz);
  const int sy = core_start(f.cy, ry, ny, cy);
  const int sx = core_start(f.cx, rx, nx, cx);
  const size_t lplane = static_cast<size_t>(ny) * nx;
  const int volume = vol ? vol[k] : 0;
  const float* lv = level + static_cast<size_t>(volume) * nz * lplane;
  int* h = ihist + warp * kHist;
  int* fh = fine + (warp >> 1) * kHist;
  const int z_lo = blockIdx.y * planes;
  const int nplanes = min(planes, cz - z_lo);

  // Range of the values the slab's gradients read (its core planes and
  // lines with the one-voxel halo), over the tiles that cover them.
  float lo = INFINITY, hi = -INFINITY;
  {
    const int ty = (ny + kTile - 1) / kTile, tx = (nx + kTile - 1) / kTile;
    const int z0 = (sz + z_lo - 1) / kTile, y0 = (sy - 1) / kTile,
              x0 = (sx - 1) / kTile;
    const int mz = (sz + z_lo + nplanes) / kTile - z0 + 1,
              my = (sy + cy) / kTile - y0 + 1,
              mx = (sx + cx) / kTile - x0 + 1;
    const float2* rg = range + static_cast<size_t>(volume) *
                                   ((nz + kTile - 1) / kTile) * ty * tx;
    for (int i = tid; i < mz * my * mx; i += kThreads) {
      const int iz = i / (my * mx), iy = i / mx % my, ix = i % mx;
      const float2 v =
          rg[(static_cast<size_t>(z0 + iz) * ty + y0 + iy) * tx + x0 + ix];
      lo = fminf(lo, v.x);
      hi = fmaxf(hi, v.y);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = fminf(lo, warp_lo[w]);
    hi = fmaxf(hi, warp_hi[w]);
  }
  // Fixed-point scale, a power of two: a contribution is at most |g| <=
  // (max - min) / 2 * |1 / units| (times the bary and hat weights, <= 1;
  // 1.01 covers the rounding), and a warp's histogram takes at most
  // kPass / kWarps voxels a pass, one contribution per bin each, so a
  // pass's sums stay below 2^30 and one scaled contribution below 2^22,
  // as the rounding in accumulate needs.
  const float inv_u = sqrtf(p.inv_ux * p.inv_ux + p.inv_uy * p.inv_uy +
                            p.inv_uz * p.inv_uz);
  const float bound = 1.01f * 0.5f * (hi - lo) * inv_u * (kPass / kWarps);
  int e2 = 0;
  frexpf(bound, &e2);   // bound < 2^e2 (e2 = 0 for a flat slab)
  const float scale =
      isfinite(bound) ? ldexpf(1.0f, min(30 - e2, 126)) : 1.0f;
  const float inv_scale = 1.0f / scale;
  // A fine histogram takes at most 2 * kPass / kWarps contributions a bin
  // a pass, each below kFineBelow * kFineGain = 2^21 once scaled (times
  // 1.01): below 2^31.
  const float fine_scale =
      isfinite(bound) ? ldexpf(kFineGain, min(30 - e2, 126 - 13)) : 1.0f;
  const float inv_fine = 1.0f / fine_scale;

  // The slab's core lines, kThreads at a time. Each thread cuts one line
  // to its span (line_span); a block-wide prefix sum of the span lengths
  // lays the candidate voxels out densely, so every thread tests one
  // candidate per step whatever the line lengths.
  const int nlines = nplanes * cy;
  for (int line0 = 0; line0 < nlines; line0 += kThreads) {
    const int line = line0 + tid;
    int len = 0, x_lo = 0, line_y = 0, line_z = 0;
    if (line < nlines) {
      const int lz = line / cy, ly = line - lz * cy;
      line_z = sz + z_lo + lz;
      line_y = sy + ly;
      const float vy =
          __fmul_rn(__fsub_rn(static_cast<float>(line_y), f.cy), p.uy);
      const float vz =
          __fmul_rn(__fsub_rn(static_cast<float>(line_z), f.cz), p.uz);
      int x_hi;
      line_span(p, f, vy, vz, sx, cx, &x_lo, &x_hi);
      len = max(0, x_hi - x_lo + 1);
    }
    // Exclusive prefix sum of len over the block.
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sum[w] : 0;
    l_off[tid] = before + incl - len;
    l_x0[tid] = x_lo;
    l_y[tid] = line_y;
    l_z[tid] = line_z;
    if (tid == kThreads - 1) l_off[kThreads] = before + incl;
    __syncthreads();
    const int total = l_off[kThreads];

    // Passes of at most kPass candidates: lane l of warp w takes
    // candidates l * q + w, l * q + w + kWarps, ... of the pass, so the
    // lanes of a warp sit q candidates apart, on different lines and mostly
    // in different bins, and each lane's candidates only move forward.
    for (int v0 = 0; v0 < total; v0 += kPass) {
      const int q = (min(kPass, total - v0) + 31) >> 5;
      int a = 0;   // line of this lane's current candidate
      for (int jj = warp; jj < q; jj += kWarps) {
        const int v = v0 + lane * q + jj;
        if (v >= total) break;
        if (jj == warp) {
          int b = kThreads - 1;   // last line with l_off <= v
          while (a < b) {
            const int m = (a + b + 1) >> 1;
            if (l_off[m] <= v) a = m; else b = m - 1;
          }
        } else {
          while (l_off[a + 1] <= v) ++a;
        }
        const int z = l_z[a], y = l_y[a], x = l_x0[a] + (v - l_off[a]);
        float sq, vb[3];
        if (!voxel_frame(p, f, x, y, z, &sq, vb)) continue;
        accumulate(p, f, lv, (static_cast<size_t>(z) * ny + y) * nx + x,
                   lplane, nx, sq, vb, scale, fine_scale, nrm, s_vinv, s_vert,
                   h, fh);
      }
      __syncthreads();
      // Fold the pass's fixed-point sums into the float histogram.
      for (int i = tid; i < kHist; i += kThreads) {
        long long sum = 0, fsum = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sum += ihist[w * kHist + i];
          ihist[w * kHist + i] = 0;
        }
#pragma unroll
        for (int w = 0; w < kWarps / 2; ++w) {
          fsum += fine[w * kHist + i];
          fine[w * kHist + i] = 0;
        }
        hist[i] += static_cast<float>(sum) * inv_scale +
                   static_cast<float>(fsum) * inv_fine;
      }
      __syncthreads();
    }
  }
  // Row k's histogram, or its slab's partial (k * slabs + slab).
  float* o = out + (static_cast<size_t>(k) * gridDim.y + blockIdx.y) * kHist;
  for (int i = tid; i < kHist; i += kThreads) o[i] = hist[i];
}

// Sum each row's slab partials (rows, slabs, 768) in slab order.
__global__ void merge_slabs_kernel(const float* __restrict__ part, int slabs,
                                   float* __restrict__ out) {
  const size_t k = blockIdx.x;
  const float* p = part + k * slabs * kHist;
  for (int i = threadIdx.x; i < kHist; i += blockDim.x) {
    float s = p[i];
    for (int j = 1; j < slabs; ++j) s += p[static_cast<size_t>(j) * kHist + i];
    out[k * kHist + i] = s;
  }
}

// Sets descrip_window_kernel's preferred shared-memory carveout on the
// current device to the least share of the SM's shared memory that holds
// kBlocksPerSm blocks (the driver rounds it up to a capacity the SM has),
// once a device. Returns the blocks an SM then holds, as the occupancy
// calculator gives them, or a negative CUDA error.
int set_carveout() {
  constexpr int kMaxDevices = 64;
  static int blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < kMaxDevices && blocks[dev] > 0) return blocks[dev];
  cudaFuncAttributes attr;
  int sm_bytes = 0, reserved = 0, n = 0;
  err = cudaFuncGetAttributes(&attr, descrip_window_kernel);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long need = static_cast<long long>(kBlocksPerSm) *
                         (attr.sharedSizeBytes + reserved);
  const int percent =
      static_cast<int>(min(100LL, (100 * need + sm_bytes - 1) / sm_bytes));
  err = cudaFuncSetAttribute(descrip_window_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             percent);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, descrip_window_kernel, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < kMaxDevices) blocks[dev] = n;
  return n;
}

}  // namespace

// Blocks of the descriptor kernel that share an SM of the current device,
// its carveout set (kBlocksPerSm when it holds), or a negative CUDA error.
extern "C" int sift3d_descrip_blocks_per_sm() { return set_carveout(); }

// Raw (unnormalized) descriptors for `num_rows` keypoints of one level
// bucket. level (nb, nz, ny, nx) f32; vol (num_rows,) i32 volume of each
// row, or null for volume 0; centers (num_rows, 3) f32 (z, y, x); rot
// (num_rows, 9) f32 row-major R; radii (rz, ry, rx) and cores (cz, cy, cx)
// the window half-extents and clamped core extents; rows split into
// `slabs` z-slabs of `planes` core planes (slabs * planes >= cz); normals
// (20, 3) f32 outward face normals in host memory; tables: the same normals
// then 20x9 inverse vertex matrices (f32, device); face_idx (20, 3) i32
// histogram vertex of each face corner; out (num_rows, 768) f32; scratch
// count * slabs * 768 f32 (unused when slabs == 1); range nb * ceil(nz / 8)
// * ceil(ny / 8) * ceil(nx / 8) float pairs. Returns the first CUDA error
// of the launches.
extern "C" int sift3d_descrip_window(
    const float* level, int nb, int nz, int ny, int nx, const int* vol,
    const float* centers, const float* rot, int num_rows, int count, int rz,
    int ry, int rx, int cz, int cy, int cx, int planes, int slabs, float ux,
    float uy, float uz, float inv_ux, float inv_uy, float inv_uz, float rad2,
    float sig2, float half_width, float bin_fctr, float bary_eps,
    const float* normals, const float* tables, const int* face_idx,
    float* out, float* scratch, float* range, void* stream) {
  if (num_rows <= 0) return 0;
  if (planes < 1 || slabs < 1 || slabs * planes < cz)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  count = max(0, min(count, num_rows));
  if (count < num_rows) {
    const cudaError_t err = cudaMemsetAsync(
        out + static_cast<size_t>(count) * kHist, 0,
        static_cast<size_t>(num_rows - count) * kHist * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (count == 0) return 0;
  Normals nrm;
  for (int i = 0; i < kFaces * 3; ++i) nrm.n[i] = normals[i];
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 3; ++j)
      if (nrm.n[3 * (10 + i) + j] != -nrm.n[3 * antipode(i) + j])
        return static_cast<int>(cudaErrorInvalidValue);
  const Params p{ux, uy, uz, inv_ux, inv_uy, inv_uz, rad2, sig2,
                 half_width, bin_fctr, bary_eps};
  const int tz = (nz + kTile - 1) / kTile, ty = (ny + kTile - 1) / kTile,
            tx = (nx + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(nb) * tz * ty * tx;
  float2* rg = reinterpret_cast<float2*>(range);
  tile_range_kernel<<<static_cast<unsigned>((tiles + kWarps - 1) / kWarps),
                      kThreads, 0, s>>>(level, nz, ny, nx, tz, ty, tx, tiles,
                                        rg);
  const int per_sm = set_carveout();
  if (per_sm < 0) return -per_sm;
  float* dst = slabs > 1 ? scratch : out;
  const dim3 grid(count, slabs);
  descrip_window_kernel<<<grid, kThreads, 0, s>>>(
      level, nz, ny, nx, vol, centers, rot, rz, ry, rx, cz, cy, cx, planes, p,
      nrm, tables, face_idx, rg, dst);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
  merge_slabs_kernel<<<count, 256, 0, s>>>(scratch, slabs, out);
  return static_cast<int>(cudaGetLastError());
}
