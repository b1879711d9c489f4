// Compacted-slot warp + NCC scoring pass for Hopper (sm_90a).
//
// Replaces the TPU kernel densepoints_tpu/ops/warp_ncc.py `_kernel_factory`
// (its resident and its streaming variant, launched by `warp_ncc_scores`,
// wrapped by `patch_ncc_scores_fused`). It computes the contract of
// `pmvs.optimize.patch_ncc_scores`: patch b carries M view slots
// view_ids[b, :] with flags ok[b, :]; slot 0 is the anchor. scores[b, m] is
// the NCC of the k x k texture of the patch plane in view view_ids[b, m]
// against the texture of slot 0 (slot 0 against itself included), for every
// slot with ok set whose 4 corners project strictly inside its view, while
// slot 0 is valid in the same sense; every other entry is -1. NCC uses
// population statistics and a 0.1 denominator clamp, two passes (mean, then
// centred covariance and variance). Sampling is that of allview_ncc.cu
// (warp_ncc_common.cuh).
//
// Not carried over from the TPU kernel: bf16 images, the row-flattened stack
// with two phase-shifted copies, 56 x 128 windows and the clamp of samples to
// them, one-hot "hat" matmuls, the 8-patch tile, the 128-lane texel padding
// and the resident / streaming split. The kernel takes the patch frames and
// the camera arrays and projects every texel in its own body, so no
// (B, M, 2, k*k) coordinate array passes through device memory.
//
// What bounds it on the H100: as in allview_ncc.cu, every texel is a
// gathered bilinear load of 4 f32 taps through L1/L2; the bytes it must move
// are the image stack once (or, when few slots are set, only the 4 taps of
// every sampled texel) plus one f32 per slot. The design keeps the
// gathers local: one block owns one patch and walks its M slots in order, the
// anchor texture is sampled once per patch and held centred in shared memory,
// the reductions run in registers and warp shuffles, and the only DRAM write
// is one score per slot. Slots with ok unset are not sampled.

#include "warp_ncc_common.cuh"

namespace {

using namespace warp_ncc;

__global__ void __launch_bounds__(kThreads)
    slot_ncc_kernel(const float* __restrict__ images, int64_t V, int64_t H,
                    int64_t W, const float* __restrict__ K,
                    const float* __restrict__ R, const float* __restrict__ C,
                    const int* __restrict__ width,
                    const int* __restrict__ height,
                    const float* __restrict__ position,
                    const float* __restrict__ sx_all,
                    const float* __restrict__ sy_all,
                    const int* __restrict__ view_ids,
                    const uint8_t* __restrict__ ok, int64_t M, int k,
                    float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int n = k * k;
  float* ca = smem;       // anchor (slot 0) texture, centred (n)
  float* tex = smem + n;  // current slot's texture (n)
  __shared__ float2 part[kWarps];
  __shared__ float2 total;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* ids = view_ids + b * M;
  const uint8_t* okrow = ok + b * M;
  float* srow = scores + b * M;
  float p[3], sx[3], sy[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = position[b * 3 + i];
    sx[i] = sx_all[b * 3 + i];
    sy[i] = sy_all[b * 3 + i];
  }
  const float nf = (float)n;
  // Every thread reads the same slot ids and flags and evaluates the same
  // corner tests, so all branches around the block reductions are uniform.
  // Slot 0, the anchor: sampled once, kept centred in shared memory.
  bool valid0 = false;
  float sa = 0.f;
  {
    const int v = ids[0];
    if (okrow[0] && v >= 0 && v < V) {
      View cam;
      load_view(cam, K, R, C, width, height, v);
      valid0 = corners_inside(cam, p, sx, sy);
      if (valid0) {
        const float* img = images + (int64_t)v * H * W;
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
    // The anchor against itself: covariance == variance == sa * sa.
    if (tid == 0) srow[0] = valid0 ? (sa * sa) / fmaxf(sa * sa, 0.1f) : -1.f;
  }
  for (int64_t m = 1; m < M; ++m) {
    float score = -1.f;
    const int v = ids[m];
    if (valid0 && okrow[m] && v >= 0 && v < V) {
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
    if (tid == 0) srow[m] = score;
  }
}

}  // namespace

extern "C" int slot_ncc_launch(
    const float* images, int64_t V, int64_t H, int64_t W, const float* K,
    const float* R, const float* C, const int* width, const int* height,
    const float* position, const float* sx, const float* sy,
    const int* view_ids, const uint8_t* ok, int64_t B, int64_t M, int k,
    float* scores, void* stream) {
  const size_t smem = 2 * (size_t)k * (size_t)k * sizeof(float);
  slot_ncc_kernel<<<(unsigned int)B, kThreads, smem, (cudaStream_t)stream>>>(
      images, V, H, W, K, R, C, width, height, position, sx, sy, view_ids, ok,
      M, k, scores);
  return (int)cudaGetLastError();
}
