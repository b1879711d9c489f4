// All-views warp + NCC scoring pass for Hopper (sm_90a).
//
// Replaces the TPU kernel densepoints_tpu/ops/warp_ncc_paged.py
// `_paged_kernel_factory` (launched by `paged_centered_textures`, driven by
// `paged_all_scores`) together with its XLA epilogue. It computes the
// contract of `allview_scores_xla`: for patch b with visible views vis[b],
// the anchor is the first visible view; scores[b, v] is the NCC of the
// k x k texture of the patch plane in view v against the anchor's texture,
// for every visible non-anchor view whose 4 corners project strictly inside
// the view, while the anchor's own warp is valid; every other entry is -1.
// NCC uses population statistics and a 0.1 denominator clamp, two passes
// (mean, then centred covariance and variance).
//
// Sampling follows the contract, not the TPU mechanics: texel (r, c) lies at
// X = p + (2c/k - 1) sx + (2r/k - 1) sy and is projected in the decomposed
// form K (R (X - C)); the bilinear sample clamps x to [0, W-1] and x0 to
// [0, W-2] against the (padded) stack size, in f32. The TPU's bf16 column
// pages, one-hot "hat" matmuls and 56 x 128 windows are not carried over.
//
// What bounds it on the H100: every texel is a gathered bilinear load of 4
// f32 taps through L1/L2. At the refine shape (8 views of 480 x 640, 9.8 MB)
// the stack stays resident in the 50 MB L2; at DTU shape (49 views of
// 1600 x 1200, 376 MB) the taps come from DRAM. The design keeps those
// gathers local: one block owns one patch and walks its views in order, so
// the k x k footprint of a view (a few cache lines per texture row) is read
// by one block while its lines are hot, the anchor texture is sampled once
// per patch and held centred in shared memory, and the NCC reductions run
// in registers and warp shuffles, so the only DRAM write is one score per
// (patch, view). Nothing here needs a gradient: Nelder-Mead is
// derivative-free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Block-wide sum of two values; every thread gets both totals.
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

__global__ void __launch_bounds__(kThreads)
    allview_ncc_kernel(const float* __restrict__ images, int64_t V, int64_t H,
                       int64_t W, const float* __restrict__ K,
                       const float* __restrict__ R,
                       const float* __restrict__ C,
                       const int* __restrict__ width,
                       const int* __restrict__ height,
                       const float* __restrict__ position,
                       const float* __restrict__ sx_all,
                       const float* __restrict__ sy_all,
                       const uint8_t* __restrict__ vis, int k,
                       float* __restrict__ scores,
                       int64_t* __restrict__ anchor_out,
                       uint8_t* __restrict__ anchor_ok_out) {
  extern __shared__ float smem[];
  const int n = k * k;
  float* ca = smem;       // anchor texture, centred (n)
  float* tex = smem + n;  // current view's texture (n)
  __shared__ float2 part[kWarps];
  __shared__ float2 total;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* vrow = vis + b * V;
  float* srow = scores + b * V;
  float p[3], sx[3], sy[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = position[b * 3 + i];
    sx[i] = sx_all[b * 3 + i];
    sy[i] = sy_all[b * 3 + i];
  }
  // Every thread scans the (short) visibility row, so the anchor and all
  // branches below are uniform across the block.
  int anchor = -1;
  for (int v = 0; v < V; ++v) {
    if (vrow[v]) {
      anchor = v;
      break;
    }
  }
  const float nf = (float)n;
  bool aok = false;
  float sa = 0.f;
  if (anchor >= 0) {
    View cam;
    load_view(cam, K, R, C, width, height, anchor);
    aok = corners_inside(cam, p, sx, sy);
    if (aok) {
      const float* img = images + (int64_t)anchor * H * W;
      float s = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const int r = i / k, c = i - r * k;
        const float t = sample(img, H, W, cam, p, sx, sy,
                               2.f * (float)c / (float)k - 1.f,
                               2.f * (float)r / (float)k - 1.f);
        ca[i] = t;
        s += t;
      }
      const float mean = block_sum2(s, 0.f, part, &total).x / nf;
      float q = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float d = ca[i] - mean;
        ca[i] = d;
        q += d * d;
      }
      sa = sqrtf(block_sum2(q, 0.f, part, &total).x / nf);
    }
  }
  if (tid == 0) {
    anchor_out[b] = anchor < 0 ? 0 : anchor;
    anchor_ok_out[b] = aok ? 1 : 0;
  }
  for (int v = 0; v < V; ++v) {
    float score = -1.f;
    if (aok && vrow[v] && v != anchor) {
      View cam;
      load_view(cam, K, R, C, width, height, v);
      if (corners_inside(cam, p, sx, sy)) {
        const float* img = images + (int64_t)v * H * W;
        float s = 0.f;
        for (int i = tid; i < n; i += kThreads) {
          const int r = i / k, c = i - r * k;
          const float t = sample(img, H, W, cam, p, sx, sy,
                                 2.f * (float)c / (float)k - 1.f,
                                 2.f * (float)r / (float)k - 1.f);
          tex[i] = t;
          s += t;
        }
        const float mean = block_sum2(s, 0.f, part, &total).x / nf;
        float q = 0.f, cv = 0.f;
        for (int i = tid; i < n; i += kThreads) {
          const float d = tex[i] - mean;
          q += d * d;
          cv += d * ca[i];
        }
        const float2 qc = block_sum2(q, cv, part, &total);
        const float st = sqrtf(qc.x / nf);
        score = (qc.y / nf) / fmaxf(sa * st, 0.1f);
      }
    }
    if (tid == 0) srow[v] = score;
  }
}

}  // namespace

extern "C" int allview_ncc_launch(
    const float* images, int64_t V, int64_t H, int64_t W, const float* K,
    const float* R, const float* C, const int* width, const int* height,
    const float* position, const float* sx, const float* sy,
    const uint8_t* vis, int64_t B, int k, float* scores, int64_t* anchor,
    uint8_t* anchor_ok, void* stream) {
  const size_t smem = 2 * (size_t)k * (size_t)k * sizeof(float);
  allview_ncc_kernel<<<(unsigned int)B, kThreads, smem,
                       (cudaStream_t)stream>>>(
      images, V, H, W, K, R, C, width, height, position, sx, sy, vis, k,
      scores, anchor, anchor_ok);
  return (int)cudaGetLastError();
}
