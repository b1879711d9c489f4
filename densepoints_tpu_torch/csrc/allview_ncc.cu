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

#include "warp_ncc_common.cuh"

namespace {

using namespace warp_ncc;

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
