// SIFT3D orientation window kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_orient_kernel_body` of
// sift3d_tpu/ops/pallas_orient.py (launched by `_orient_pallas_call`). For
// each keypoint row below `count` it takes the nine Gaussian-weighted sums
// of the orientation structure tensor (reference assign_eig_ori,
// sift3d/sift.c:1354-1426) over the row's clamped core window of one
// Gaussian pyramid level:
//   - core starts clip(c - R, 1, n - 1 - core) per axis, c the row's
//     integer centre (features/windows.window_starts);
//   - per voxel: offset d = voxel - c, v = d * units; the voxel counts when
//     |d| <= R on each axis and |v|^2 <= rad^2; weight
//     w = exp(-0.5 |v|^2 / sigma^2);
//   - unit-corrected central differences g = 0.5 (I[+1] - I[-1]) / u;
//   - six sums w gi gj (xx, xy, xz, yy, yz, zz) in float64 from float64
//     casts of the fp32 g and w, as the JAX package's eager path does, and
//     three sums w gi (the window gradient), written as fp32.
// Rows at or past `count` are written as zeros. Rows may come from
// different volumes of a batch: row k reads volume rows[4k] of a
// (B, nz, ny, nx) level.
//
// The fp32 values are formed with unfused IEEE operations in the plain
// version's order (__fmul_rn / __fadd_rn / __fdiv_rn), so the masks agree
// voxel for voxel and the weights and gradients to expf's rounding.
//
// Design: one thread block per keypoint row; 256 threads stride over the
// core's voxels (at most 25^3 on the levels SIFT3D uses), reading the
// level in place at the row's volume and window start (no stacked
// per-keypoint window copy in device memory); each thread keeps its nine
// sums in registers; a warp-shuffle reduction and one shared-memory step
// across the 8 warps finish the row, and thread 0 writes it.
//
// What bounds it on the H100: float64 arithmetic, not device memory. A
// voxel inside the sphere costs about 23 fp32 and 21 fp64 operations
// against 6 fp32 reads that mostly hit L1 (neighbouring voxels share
// them); the H100's fp64 rate is half its fp32 rate, so the f64 sums
// (kept for row-exact keypoints) set the bound. Voxels outside the box or
// the sphere are skipped before any load.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 9;

struct Params {
  float ux, uy, uz;              // voxel spacing (mm)
  float inv_ux, inv_uy, inv_uz;  // 1 / spacing, rounded in fp32
  float rad2;                    // window radius^2 (mm^2)
  float sig2;                    // Gaussian sigma^2 (mm^2)
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 0.5 * (hi - lo) * inv, in that order, unfused.
__device__ __forceinline__ float central(float hi, float lo, float inv) {
  return __fmul_rn(__fmul_rn(0.5f, __fsub_rn(hi, lo)), inv);
}

__global__ void __launch_bounds__(kThreads) orient_window_kernel(
    const float* __restrict__ level, int nz, int ny, int nx,
    const int* __restrict__ rows, int count, int cz, int cy, int cx, int rz,
    int ry, int rx, Params p, double* __restrict__ a6,
    float* __restrict__ vd) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  if (k >= count) {
    if (tid < 6) a6[6 * k + tid] = 0.0;
    else if (tid < kSums) vd[3 * k + tid - 6] = 0.0f;
    return;
  }
  const int b = rows[4 * k];
  const int z0 = rows[4 * k + 1], y0 = rows[4 * k + 2], x0 = rows[4 * k + 3];
  const int sz = clip(z0 - rz, 1, nz - 1 - cz);
  const int sy = clip(y0 - ry, 1, ny - 1 - cy);
  const int sx = clip(x0 - rx, 1, nx - 1 - cx);
  const size_t plane = static_cast<size_t>(ny) * nx;
  const float* lv = level + static_cast<size_t>(b) * nz * plane;

  double s[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) s[i] = 0.0;

  const int wplane = cy * cx;
  const int nvox = cz * wplane;
  for (int v = tid; v < nvox; v += kThreads) {
    const int iz = v / wplane;
    const int rem = v - iz * wplane;
    const int iy = rem / cx;
    const int ix = rem - iy * cx;
    const int z = sz + iz, y = sy + iy, x = sx + ix;
    const int dz = z - z0, dy = y - y0, dx = x - x0;
    if (abs(dx) > rx || abs(dy) > ry || abs(dz) > rz) continue;
    const float vx = __fmul_rn(static_cast<float>(dx), p.ux);
    const float vy = __fmul_rn(static_cast<float>(dy), p.uy);
    const float vz = __fmul_rn(static_cast<float>(dz), p.uz);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                               __fmul_rn(vz, vz));
    if (!(sq <= p.rad2)) continue;
    const float w = expf(__fdiv_rn(__fmul_rn(-0.5f, sq), p.sig2));

    const size_t c = (static_cast<size_t>(z) * ny + y) * nx + x;
    const float gx = central(lv[c + 1], lv[c - 1], p.inv_ux);
    const float gy = central(lv[c + nx], lv[c - nx], p.inv_uy);
    const float gz = central(lv[c + plane], lv[c - plane], p.inv_uz);

    const double gx64 = gx, gy64 = gy, gz64 = gz, w64 = w;
    s[0] = __dadd_rn(s[0], __dmul_rn(__dmul_rn(gx64, gx64), w64));
    s[1] = __dadd_rn(s[1], __dmul_rn(__dmul_rn(gx64, gy64), w64));
    s[2] = __dadd_rn(s[2], __dmul_rn(__dmul_rn(gx64, gz64), w64));
    s[3] = __dadd_rn(s[3], __dmul_rn(__dmul_rn(gy64, gy64), w64));
    s[4] = __dadd_rn(s[4], __dmul_rn(__dmul_rn(gy64, gz64), w64));
    s[5] = __dadd_rn(s[5], __dmul_rn(__dmul_rn(gz64, gz64), w64));
    s[6] = __dadd_rn(s[6], static_cast<double>(__fmul_rn(gx, w)));
    s[7] = __dadd_rn(s[7], static_cast<double>(__fmul_rn(gy, w)));
    s[8] = __dadd_rn(s[8], static_cast<double>(__fmul_rn(gz, w)));
  }

#pragma unroll
  for (int i = 0; i < kSums; ++i)
    for (int off = 16; off > 0; off >>= 1)
      s[i] += __shfl_down_sync(0xffffffffu, s[i], off);
  __shared__ double part[kWarps][kSums];
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) part[warp][i] = s[i];
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kSums; ++i) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t += part[w][i];
      if (i < 6) a6[6 * k + i] = t;
      else vd[3 * k + i - 6] = static_cast<float>(t);
    }
  }
}

}  // namespace

// Structure-tensor sums for `num_rows` keypoints of one level bucket.
// level (B, nz, ny, nx) f32; rows (num_rows, 4) i32 (volume, z, y, x);
// cores and radii in (z, y, x) order; a6 (num_rows, 6) f64 and
// vd (num_rows, 3) f32 outputs. Returns cudaGetLastError() after the
// launch.
extern "C" int sift3d_orient_window(
    const float* level, int nz, int ny, int nx, const int* rows,
    int num_rows, int count, int cz, int cy, int cx, int rz, int ry, int rx,
    float ux, float uy, float uz, float inv_ux, float inv_uy, float inv_uz,
    float rad2, float sig2, double* a6, float* vd, void* stream) {
  if (num_rows <= 0) return 0;
  const Params p{ux, uy, uz, inv_ux, inv_uy, inv_uz, rad2, sig2};
  orient_window_kernel<<<num_rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      level, nz, ny, nx, rows, count, cz, cy, cx, rz, ry, rx, p, a6, vd);
  return static_cast<int>(cudaGetLastError());
}
