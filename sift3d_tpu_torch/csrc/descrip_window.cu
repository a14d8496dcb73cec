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
// rows of a batch into one grid in the same way).
//
// Design: one thread block per keypoint; threads stride over the window's
// voxels, reading the level directly at the row's volume and window start
// (no stacked per-keypoint window copy in device memory); the 768-float histogram lives
// in shared memory, updated with shared atomicAdd (at most 24 per voxel),
// and is written once, coalesced, at the end. Everything is fp32.
//
// What bounds it on the H100: arithmetic and shared atomics, not device
// memory. A 74^3 core window is 1.6 MB of level reads (mostly from L1/L2:
// neighbouring voxels and keypoints overlap) against ~260 fp32 operations
// and 24 shared atomics per voxel that lies in the sphere. The per-voxel
// geometry tests run first and skip all further work for the ~half of the
// box that lies outside the sphere or the rotated bin cube.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFaces = 20;
constexpr int kHist = 768;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads) descrip_window_kernel(
    const float* __restrict__ level, int nz, int ny, int nx,
    const int* __restrict__ vol, const int* __restrict__ starts, const float* __restrict__ centers,
    const float* __restrict__ rot, int count, int cz, int cy, int cx,
    Params p, const float* __restrict__ tables,
    const int* __restrict__ face_idx, float* __restrict__ out) {
  __shared__ float hist[kHist];
  __shared__ float s_norm[kFaces * 3];
  __shared__ float s_vinv[kFaces * 9];
  __shared__ int s_vert[kFaces * 3];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + static_cast<size_t>(k) * kHist;
  if (k >= count) {
    for (int i = tid; i < kHist; i += blockDim.x) o[i] = 0.0f;
    return;
  }
  for (int i = tid; i < kHist; i += blockDim.x) hist[i] = 0.0f;
  for (int i = tid; i < kFaces * 3; i += blockDim.x) {
    s_norm[i] = tables[i];
    s_vert[i] = face_idx[i];
  }
  for (int i = tid; i < kFaces * 9; i += blockDim.x)
    s_vinv[i] = tables[kFaces * 3 + i];
  __syncthreads();

  const int sz = starts[3 * k], sy = starts[3 * k + 1], sx = starts[3 * k + 2];
  const float czf = centers[3 * k], cyf = centers[3 * k + 1],
              cxf = centers[3 * k + 2];
  // R row-major; the kernel applies R^T: (R^T u)_i = sum_j R[j][i] u_j.
  const float* r = rot + 9 * k;
  const float r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4],
              r5 = r[5], r6 = r[6], r7 = r[7], r8 = r[8];
  const size_t lplane = static_cast<size_t>(ny) * nx;
  const float* lv = level + static_cast<size_t>(vol[k]) * nz * lplane;
  const int wplane = cy * cx;
  const int nvox = cz * wplane;

  for (int v = tid; v < nvox; v += blockDim.x) {
    const int iz = v / wplane;
    const int rem = v - iz * wplane;
    const int iy = rem / cx;
    const int ix = rem - iy * cx;
    const int z = sz + iz, y = sy + iy, x = sx + ix;

    // Geometry tests in unfused IEEE fp32, the plain version's rounding,
    // so the sphere and bin-cube masks agree voxel for voxel.
    const float vx = __fmul_rn(__fsub_rn(static_cast<float>(x), cxf), p.ux);
    const float vy = __fmul_rn(__fsub_rn(static_cast<float>(y), cyf), p.uy);
    const float vz = __fmul_rn(__fsub_rn(static_cast<float>(z), czf), p.uz);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                               __fmul_rn(vz, vz));
    if (!(sq <= p.rad2)) continue;
    const float kx = __fadd_rn(__fadd_rn(__fmul_rn(r0, vx), __fmul_rn(r3, vy)),
                               __fmul_rn(r6, vz));
    const float ky = __fadd_rn(__fadd_rn(__fmul_rn(r1, vx), __fmul_rn(r4, vy)),
                               __fmul_rn(r7, vz));
    const float kz = __fadd_rn(__fadd_rn(__fmul_rn(r2, vx), __fmul_rn(r5, vy)),
                               __fmul_rn(r8, vz));
    const float vbx = __fmul_rn(__fadd_rn(kx, p.half_width), p.bin_fctr);
    const float vby = __fmul_rn(__fadd_rn(ky, p.half_width), p.bin_fctr);
    const float vbz = __fmul_rn(__fadd_rn(kz, p.half_width), p.bin_fctr);
    if (!(vbx >= 0.0f && vby >= 0.0f && vbz >= 0.0f && vbx < 4.0f &&
          vby < 4.0f && vbz < 4.0f))
      continue;

    const float w = expf(-0.5f * sq / p.sig2);
    const size_t c = (static_cast<size_t>(z) * ny + y) * nx + x;
    const float gx = 0.5f * (lv[c + 1] - lv[c - 1]) * p.inv_ux * w;
    const float gy = 0.5f * (lv[c + nx] - lv[c - nx]) * p.inv_uy * w;
    const float gz = 0.5f * (lv[c + lplane] - lv[c - lplane]) * p.inv_uz * w;
    const float grx = r0 * gx + r3 * gy + r6 * gz;
    const float gry = r1 * gx + r4 * gy + r7 * gz;
    const float grz = r2 * gx + r5 * gy + r8 * gz;
    const float mag2 = grx * grx + gry * gry + grz * grz;
    if (!(mag2 >= p.bary_eps)) continue;

    int face = 0;
    float best = s_norm[0] * grx + s_norm[1] * gry + s_norm[2] * grz;
#pragma unroll
    for (int f = 1; f < kFaces; ++f) {
      const float s = s_norm[3 * f] * grx + s_norm[3 * f + 1] * gry +
                      s_norm[3 * f + 2] * grz;
      if (s > best) {
        best = s;
        face = f;
      }
    }
    const float* m = s_vinv + 9 * face;
    const float b0 = m[0] * grx + m[1] * gry + m[2] * grz;
    const float b1 = m[3] * grx + m[4] * gry + m[5] * grz;
    const float b2 = m[6] * grx + m[7] * gry + m[8] * grz;
    const float bsum = b0 + b1 + b2;
    if (!(bsum > 0.0f)) continue;
    const float mag = sqrtf(mag2);
    const float val[3] = {b0 / bsum * mag, b1 / bsum * mag, b2 / bsum * mag};
    const int* vert = s_vert + 3 * face;

    int lz, ly, lx;
    float wz[2], wy[2], wx[2];
    hat(vbz, &lz, &wz[0], &wz[1]);
    hat(vby, &ly, &wy[0], &wy[1]);
    hat(vbx, &lx, &wx[0], &wx[1]);
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
          const float sw = wzy * wx[d];
          float* h = hist + ((hz * 4 + hy) * 4 + hx) * 12;
          atomicAdd(h + vert[0], sw * val[0]);
          atomicAdd(h + vert[1], sw * val[1]);
          atomicAdd(h + vert[2], sw * val[2]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kHist; i += blockDim.x) o[i] = hist[i];
}

}  // namespace

// Raw (unnormalized) descriptors for `num_rows` keypoints of one level
// bucket. level (B, nz, ny, nx) f32; vol (num_rows,) i32 volume of each
// row; starts (num_rows, 3) i32 core starts (z, y, x);
// centers (num_rows, 3) f32 (z, y, x); rot (num_rows, 9) f32 row-major R;
// tables: 20x3 outward normals then 20x9 inverse vertex matrices (f32);
// face_idx (20, 3) i32 histogram vertex of each face corner;
// out (num_rows, 768) f32. Returns cudaGetLastError() after the launch.
extern "C" int sift3d_descrip_window(
    const float* level, int nz, int ny, int nx, const int* vol,
    const int* starts,
    const float* centers, const float* rot, int num_rows, int count, int cz,
    int cy, int cx, float ux, float uy, float uz, float inv_ux, float inv_uy,
    float inv_uz, float rad2, float sig2, float half_width, float bin_fctr,
    float bary_eps, const float* tables, const int* face_idx, float* out,
    void* stream) {
  if (num_rows <= 0) return 0;
  const Params p{ux, uy, uz, inv_ux, inv_uy, inv_uz, rad2, sig2,
                 half_width, bin_fctr, bary_eps};
  descrip_window_kernel<<<num_rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      level, nz, ny, nx, vol, starts, centers, rot, count, cz, cy, cx, p, tables,
      face_idx, out);
  return static_cast<int>(cudaGetLastError());
}
