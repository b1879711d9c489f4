// All-views warp + NCC scoring pass for Hopper (sm_90a).
//
// Replaces the TPU kernel densepoints_tpu/ops/warp_ncc_paged.py
// `_paged_kernel_factory` (launched by `paged_centered_textures`, driven by
// `paged_all_scores`) together with its XLA epilogue and the patch frames
// computed before it. It computes the contract of `allview_scores_xla`: for
// patch b with visible views vis[b], the anchor is the first visible view;
// scores[b, v] is the NCC of the k x k texture of the patch plane in view v
// against the anchor's texture, for every visible non-anchor view whose 4
// corners project strictly inside the view, while the anchor's own warp is
// valid; every other entry is -1. NCC uses population statistics and a 0.1
// denominator clamp, two passes (mean, then centred covariance and
// variance). The TPU's bf16 column pages, one-hot "hat" matmuls and
// 56 x 128 windows are not carried over.
//
// What bounds it on the H100: every texel is a gathered bilinear load of 4
// f32 taps through L1/L2. At the refine shape (8 views of 480 x 640, 9.8 MB)
// the stack stays resident in the 50 MB L2 and the kernel is bound by the
// arithmetic around each tap; at DTU shape (49 views of 1600 x 1200, 376 MB)
// the taps come from DRAM and their latency counts beside that arithmetic.
// The design (`score_row` in warp_ncc_common.cuh) therefore spends as few
// operations per texel as the contract allows and keeps every warp busy:
// one warp owns one patch and never waits for another (no block barrier);
// it takes the views in tiles of 32, a ballot of the visibility flags per
// tile, so any number of views fits its shared memory; four lanes set up
// each visible view of a tile once (camera, corner test, texel homography,
// all from position, normal and the reference view, so no frame array
// passes through device memory); the first tile with a flag names the
// anchor; the anchor texture is sampled once and kept centred in shared
// memory; then the warp takes the live views of each tile one after
// another, the whole texture of a view in registers, every tap loaded
// before any is blended, statistics by warp shuffles, one score written per
// view. A block is four such warps, and 28 warps fit an SM.
// Nothing here needs a gradient: Nelder-Mead is derivative-free.

#include "warp_ncc_common.cuh"

namespace {

using namespace warp_ncc;

// A visibility row: entry v is view v, the anchor is the first visible one.
struct VisibilityRow {
  const uint8_t* vis;
  int V;
  static constexpr bool kSlots = false;
  __device__ int count() const { return V; }
  __device__ bool flagged(int e) const { return vis[e] != 0; }
  __device__ int view(int e) const { return e; }
};

template <int T>
__global__ void __launch_bounds__(kRowWarps * 32, kRowBlocks)
    allview_ncc_kernel(Scene sc, const uint8_t* __restrict__ vis,
                       float* __restrict__ scores,
                       int64_t* __restrict__ anchor_out,
                       uint8_t* __restrict__ anchor_ok_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kRowWarps + warp;
  if (b >= sc.B) return;  // whole warps leave; nobody waits for them
  const VisibilityRow row{vis + b * sc.V, sc.V};
  score_row<T>(sc, b, row, scores + b * sc.V, anchor_out + b,
               anchor_ok_out + b,
               smem + warp * row_smem_words(sc.k));
}

}  // namespace

extern "C" int allview_ncc_launch(
    const float* images, int64_t V, int64_t H, int64_t W, const float* K,
    const float* E, const float* C, const float* x_axis, const int* width,
    const int* height, const float* position, const float* normal,
    const int64_t* ref, const uint8_t* vis, int64_t B, int k, float* scores,
    int64_t* anchor, uint8_t* anchor_ok, void* stream) {
  const Scene sc = make_scene(images, V, H, W, K, E, C, x_axis, width,
                              height, position, normal, ref, B, k);
  const size_t smem = kRowWarps * row_smem_words(k) * sizeof(float);
  const unsigned int grid = (unsigned int)((B + kRowWarps - 1) / kRowWarps);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(T)                                       \
  allview_ncc_kernel<T><<<grid, kRowWarps * 32, smem, st>>>(  \
      sc, vis, scores, anchor, anchor_ok)
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
