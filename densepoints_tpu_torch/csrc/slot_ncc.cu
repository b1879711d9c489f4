// Compacted-slot warp + NCC scoring pass for Hopper (sm_90a).
//
// Replaces the TPU kernel densepoints_tpu/ops/warp_ncc.py `_kernel_factory`
// (its resident and its streaming variant, launched by `warp_ncc_scores`,
// wrapped by `patch_ncc_scores_fused`) and the patch frames computed before
// it. It computes the contract of `pmvs.optimize.patch_ncc_scores`: patch b
// carries M view slots view_ids[b, :] with flags ok[b, :]; slot 0 is the
// anchor. scores[b, m] is the NCC of the k x k texture of the patch plane in
// view view_ids[b, m] against the texture of slot 0 (slot 0 against itself
// included), for every slot with ok set whose 4 corners project strictly
// inside its view, while slot 0 is valid in the same sense; every other
// entry is -1. A slot whose view id lies outside [0, V) counts as not ok.
// NCC uses population statistics and a 0.1 denominator clamp, two passes
// (mean, then centred covariance and variance).
//
// Not carried over from the TPU kernel: bf16 images, the row-flattened stack
// with two phase-shifted copies, 56 x 128 windows and the clamp of samples to
// them, one-hot "hat" matmuls, the 8-patch tile, the 128-lane texel padding
// and the resident / streaming split. No (B, M, 2, k*k) coordinate array and
// no frame array passes through device memory.
//
// What bounds it on the H100: as in allview_ncc.cu, every texel is a
// gathered bilinear load of 4 f32 taps through L1/L2; the bytes it must move
// are the image stack once (or, when few slots are set, only the 4 taps of
// every sampled texel) plus one f32 per slot. The design is that of
// allview_ncc.cu (`score_row` in warp_ncc_common.cuh) over slots instead of
// views: one warp owns one patch, four lanes set up each ok slot once, the
// anchor texture of slot 0 is sampled into registers and kept there centred,
// then the warp takes its live slots one after another with the whole
// texture in registers and every tap in flight. Slots with ok unset are
// neither set up nor sampled.

#include "warp_ncc_common.cuh"

namespace {

using namespace warp_ncc;

// A slot table's row: entry m names view ids[m]; the anchor is slot 0.
struct SlotRow {
  const int* ids;
  const uint8_t* ok;
  int M, V;
  static constexpr bool kSlots = true;
  __device__ int count() const { return M; }
  __device__ bool flagged(int e) const {
    return ok[e] != 0 && ids[e] >= 0 && ids[e] < V;
  }
  __device__ int view(int e) const { return ids[e]; }
};

template <int T>
__global__ void __launch_bounds__(kRowWarps * 32, kRowBlocks)
    slot_ncc_kernel(Scene sc, const int* __restrict__ view_ids,
                    const uint8_t* __restrict__ ok, int M,
                    float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kRowWarps + warp;
  if (b >= sc.B) return;  // whole warps leave; nobody waits for them
  const SlotRow row{view_ids + b * M, ok + b * M, M, sc.V};
  score_row<T>(sc, b, row, scores + b * M, nullptr, nullptr,
               smem + warp * row_smem_words(sc.k, M));
}

}  // namespace

extern "C" int slot_ncc_launch(
    const float* images, int64_t V, int64_t H, int64_t W, const float* K,
    const float* E, const float* C, const float* x_axis, const int* width,
    const int* height, const float* position, const float* normal,
    const int64_t* ref, const int* view_ids, const uint8_t* ok, int64_t B,
    int64_t M, int k, float* scores, void* stream) {
  const Scene sc{images, (int)V, (int)H, (int)W, K,      E,   C, x_axis,
                 width,  height, position, normal, ref, B, k};
  const size_t smem = kRowWarps * row_smem_words(k, (int)M) * sizeof(float);
  const unsigned int grid = (unsigned int)((B + kRowWarps - 1) / kRowWarps);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(T)                                    \
  slot_ncc_kernel<T><<<grid, kRowWarps * 32, smem, st>>>(  \
      sc, view_ids, ok, (int)M, scores)
  switch (texels_per_lane(k)) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    default: LAUNCH(0); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
