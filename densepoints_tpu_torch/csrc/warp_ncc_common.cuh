// Device code shared by the warp + NCC kernels (allview_ncc.cu, slot_ncc.cu)
// and the row-wise NCC kernel (ncc_pairs.cu): the per-view camera, the
// decomposed projection, the strict 4-corner bounds test, the clamp-to-edge
// bilinear sample with 64-bit offsets, and the warp / block reductions.
//
// Sampling follows the scoring contract: texel (r, c) of a k x k texture lies
// at X = p + (2c/k - 1) sx + (2r/k - 1) sy and is projected in the decomposed
// form K (R (X - C)); the bilinear sample clamps x to [0, W-1] and x0 to
// [0, W-2] against the (padded) stack size, in f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_ncc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct View {
  float K[9];
  float R[9];
  float C[3];
  float w, h;
};

__device__ __forceinline__ void load_view(View& cam, const float* K,
                                          const float* R, const float* C,
                                          const int* width, const int* height,
                                          int v) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    cam.K[i] = K[v * 9 + i];
    cam.R[i] = R[v * 9 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) cam.C[i] = C[v * 3 + i];
  cam.w = (float)width[v];
  cam.h = (float)height[v];
}

// pix = K (R (X - C)), dehomogenized.
__device__ __forceinline__ void project(const View& cam, float x, float y,
                                       float z, float& px, float& py) {
  const float r0 = x - cam.C[0], r1 = y - cam.C[1], r2 = z - cam.C[2];
  const float c0 = cam.R[0] * r0 + cam.R[1] * r1 + cam.R[2] * r2;
  const float c1 = cam.R[3] * r0 + cam.R[4] * r1 + cam.R[5] * r2;
  const float c2 = cam.R[6] * r0 + cam.R[7] * r1 + cam.R[8] * r2;
  const float h0 = cam.K[0] * c0 + cam.K[1] * c1 + cam.K[2] * c2;
  const float h1 = cam.K[3] * c0 + cam.K[4] * c1 + cam.K[5] * c2;
  const float h2 = cam.K[6] * c0 + cam.K[7] * c1 + cam.K[8] * c2;
  px = h0 / h2;
  py = h1 / h2;
}

// Strict-bounds test of the 4 corners p -+ sx -+ sy against the view size.
__device__ __forceinline__ bool corners_inside(const View& cam,
                                               const float* p,
                                               const float* sx,
                                               const float* sy) {
  const float su[4] = {-1.f, 1.f, 1.f, -1.f};
  const float sv[4] = {-1.f, -1.f, 1.f, 1.f};
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = p[i] + (su[c] * sx[i] + sv[c] * sy[i]);
    float px, py;
    project(cam, q[0], q[1], q[2], px, py);
    ok = ok && (px > 0.f) && (px < cam.w) && (py > 0.f) && (py < cam.h);
  }
  return ok;
}

__device__ __forceinline__ float sample(const float* img, int64_t H,
                                        int64_t W, const View& cam,
                                        const float* p, const float* sx,
                                        const float* sy, float ss, float tt) {
  const float x = (p[0] + ss * sx[0]) + tt * sy[0];
  const float y = (p[1] + ss * sx[1]) + tt * sy[1];
  const float z = (p[2] + ss * sx[2]) + tt * sy[2];
  float px, py;
  project(cam, x, y, z, px, py);
  // fmaxf/fminf drop a NaN operand, so a degenerate projection clamps to 0.
  px = fminf(fmaxf(px, 0.f), (float)(W - 1));
  py = fminf(fmaxf(py, 0.f), (float)(H - 1));
  int64_t x0 = (int64_t)floorf(px);
  int64_t y0 = (int64_t)floorf(py);
  x0 = x0 < 0 ? 0 : (x0 > W - 2 ? W - 2 : x0);
  y0 = y0 < 0 ? 0 : (y0 > H - 2 ? H - 2 : y0);
  const float dx = px - (float)x0;
  const float dy = py - (float)y0;
  const float* row = img + y0 * W + x0;
  const float i00 = __ldg(row), i01 = __ldg(row + 1);
  const float i10 = __ldg(row + W), i11 = __ldg(row + W + 1);
  return i00 * (1.f - dx) * (1.f - dy) + i01 * dx * (1.f - dy) +
         i10 * (1.f - dx) * dy + i11 * dx * dy;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of two values over kThreads threads; every thread gets
// both totals. Every thread of the block must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* part,
                                             float2* total) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < kWarps ? part[lane] : make_float2(0.f, 0.f);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
    if (lane == 0) *total = s;
  }
  __syncthreads();
  return *total;
}

}  // namespace warp_ncc
