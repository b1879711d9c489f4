// Window-relative sampling + NCC against slot 0, with ablation variants, for
// Hopper (sm_90a).
//
// Replaces the TPU ablation kernels scripts/kernel_ablate.py `make_variant`
// and `make_grad_variant`. Patch b carries M slots; slot m samples n texels
// at (xs, ys)[b, m, :n] inside the win_h x win_w window whose corner is
// (row0, x0)[b, m] of a row-flattened image stack (window_sample.cuh has the
// sampling contract). scores[b, m] = cov / max(sqrt(va) * sqrt(vt), 0.1) of
// slot m's texture against slot 0's, population statistics in two passes;
// slot 0 scores itself. No visibility and no sentinels. With a gradient
// stack the x-blend is left + fx * grad (the `make_grad_variant` form).
//
// Not carried over from the TPU kernels: the one-hot "hat" matmuls and their
// MXU orientations (`onehot`, `transposed`, `fused`), TILE_B (`tile16`), the
// 128-lane texel padding, the 8-row / 128-column alignment of the corners and
// bf16 stacks. Their variants probe the MXU; the variants here switch off
// what costs time on this card:
//   full      gathered taps, two block reductions per slot (one block per
//             patch walks its M slots, as slot_ncc.cu does);
//   noload    taps computed from the coordinates, no load of the stack:
//             what the gathers cost;
//   noreduce  taps gathered, but every thread keeps its own partial sums:
//             what the two reductions and their barriers cost;
//   bare      `noload` and `noreduce` together: the coordinate reads, the
//             arithmetic and the walk over the slots that are left;
//   staged    the block first copies the slot's window into shared memory
//             with coalesced loads and takes its taps there;
//   warp_slot one warp per slot (a warp walks the M slots of its patch, four
//             patches per block), reductions by shuffle only, no block
//             barrier.
// `noload`, `noreduce` and `bare` no longer compute the scores; they only
// bound a cost. The others compute the same scores.
//
// What bounds it on the H100: bytes by the count (8 B of coordinates and at
// most 16 B of stack per texel, one f32 out per slot), but like slot_ncc.cu
// it runs far above that bound; the variants exist to say why.

#include "window_sample.cuh"

namespace {

using namespace warp_ncc;
using namespace window;

constexpr float kNever = -12345.f;  // no score takes this value

// Sum of two values over the block, or (kNoReduce bit) the thread's own pair.
template <int kVariant>
__device__ __forceinline__ float2 reduce2(float a, float b, float2* part,
                                          float2* total) {
  if (kVariant & kNoReduce) return make_float2(a, b);
  return block_sum2(a, b, part, total);
}

template <int kVariant, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    window_ncc_kernel(const float* __restrict__ stack,
                      const float* __restrict__ grad, int64_t rows,
                      int64_t width, const int* __restrict__ row0,
                      const int* __restrict__ x0,
                      const float* __restrict__ xs,
                      const float* __restrict__ ys, int64_t M, int64_t S,
                      int n, int win_h, int win_w,
                      float* __restrict__ scores) {
  extern __shared__ float smem[];
  float* ca = smem;           // slot 0's texture, centred (n)
  float* tex = smem + n;      // current slot's texture (n)
  float* win = smem + 2 * n;  // the staged window (kStaged only)
  __shared__ float2 part[kWarps];
  __shared__ float2 total;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const float nf = (float)n;
  float va = 0.f;
  for (int64_t m = 0; m < M; ++m) {
    const int64_t slot = b * M + m;
    const Window w =
        make_window(row0[slot], x0[slot], rows, width, win_h, win_w);
    // The taps of the slot before were all taken before its reductions'
    // barriers, so the window may be overwritten here.
    if (kVariant == kStaged) stage_window(stack, width, w, win_h, win_w, win);
    const float* px = xs + slot * S;
    const float* py = ys + slot * S;
    float s = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float t = texel<kVariant, kGrad>(stack, grad, win, width, w,
                                             win_h, win_w, px[i], py[i]);
      tex[i] = t;
      s += t;
    }
    const float mean = reduce2<kVariant>(s, 0.f, part, &total).x / nf;
    float q = 0.f, cv = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float d = tex[i] - mean;
      q += d * d;
      if (m == 0) {
        ca[i] = d;  // read back by this thread only
        cv += d * d;
      } else {
        cv += d * ca[i];
      }
    }
    const float2 qc = reduce2<kVariant>(q, cv, part, &total);
    const float vt = qc.x / nf;
    if (m == 0) va = vt;
    const float score = (qc.y / nf) / fmaxf(sqrtf(va) * sqrtf(vt), 0.1f);
    // kNoReduce bit: the comparison keeps every thread's work alive.
    if (tid == 0 || ((kVariant & kNoReduce) && score == kNever)) {
      scores[slot] = score;
    }
  }
}

// One warp per slot: warp j of a block walks the M slots of patch
// 4 * blockIdx.x + j; lane l holds texels l, l + 32, ...
__global__ void __launch_bounds__(kThreads)
    window_ncc_warp_kernel(const float* __restrict__ stack, int64_t rows,
                           int64_t width, const int* __restrict__ row0,
                           const int* __restrict__ x0,
                           const float* __restrict__ xs,
                           const float* __restrict__ ys, int64_t B,
                           int64_t M, int64_t S, int n, int win_h,
                           int win_w, float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps leave together; no block barrier below
  float* ca = smem + (size_t)warp * 2 * n;
  float* tex = ca + n;
  const float nf = (float)n;
  float va = 0.f;
  for (int64_t m = 0; m < M; ++m) {
    const int64_t slot = b * M + m;
    const Window w =
        make_window(row0[slot], x0[slot], rows, width, win_h, win_w);
    const float* px = xs + slot * S;
    const float* py = ys + slot * S;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float t = texel<kFull, false>(stack, nullptr, nullptr, width, w,
                                          win_h, win_w, px[i], py[i]);
      tex[i] = t;
      s += t;
    }
    const float mean = warp_sum(s) / nf;
    float q = 0.f, cv = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = tex[i] - mean;
      q += d * d;
      if (m == 0) {
        ca[i] = d;
        cv += d * d;
      } else {
        cv += d * ca[i];
      }
    }
    const float vt = warp_sum(q) / nf;
    const float cov = warp_sum(cv) / nf;
    if (m == 0) va = vt;
    if (lane == 0) {
      scores[slot] = cov / fmaxf(sqrtf(va) * sqrtf(vt), 0.1f);
    }
  }
}

template <int kVariant, bool kGrad>
int launch_block(const float* stack, const float* grad, int64_t rows,
                 int64_t width, const int* row0, const int* x0,
                 const float* xs, const float* ys, int64_t B, int64_t M,
                 int64_t S, int n, int win_h, int win_w, float* scores,
                 void* stream) {
  size_t floats = 2 * (size_t)n;
  if (kVariant == kStaged) floats += (size_t)win_h * (size_t)win_w;
  window_ncc_kernel<kVariant, kGrad>
      <<<(unsigned int)B, kThreads, floats * sizeof(float),
         (cudaStream_t)stream>>>(stack, grad, rows, width, row0, x0, xs, ys,
                                 M, S, n, win_h, win_w, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per variant, all with one signature. `grad` is read by the
// grad launchers only and may be null for the others.
#define WINDOW_NCC_LAUNCHER(name, variant, with_grad)                        \
  extern "C" int name(const float* stack, const float* grad, int64_t rows,   \
                      int64_t width, const int* row0, const int* x0,         \
                      const float* xs, const float* ys, int64_t B,           \
                      int64_t M, int64_t S, int n, int win_h, int win_w,     \
                      float* scores, void* stream) {                         \
    return launch_block<variant, with_grad>(stack, grad, rows, width, row0,  \
                                            x0, xs, ys, B, M, S, n, win_h,   \
                                            win_w, scores, stream);          \
  }

WINDOW_NCC_LAUNCHER(window_ncc_full, window::kFull, false)
WINDOW_NCC_LAUNCHER(window_ncc_noload, window::kNoLoad, false)
WINDOW_NCC_LAUNCHER(window_ncc_noreduce, window::kNoReduce, false)
WINDOW_NCC_LAUNCHER(window_ncc_bare, window::kBare, false)
WINDOW_NCC_LAUNCHER(window_ncc_staged, window::kStaged, false)
WINDOW_NCC_LAUNCHER(window_ncc_grad_full, window::kFull, true)
WINDOW_NCC_LAUNCHER(window_ncc_grad_noload, window::kNoLoad, true)
WINDOW_NCC_LAUNCHER(window_ncc_grad_noreduce, window::kNoReduce, true)

extern "C" int window_ncc_warp_slot(const float* stack, const float* grad,
                                    int64_t rows, int64_t width,
                                    const int* row0, const int* x0,
                                    const float* xs, const float* ys,
                                    int64_t B, int64_t M, int64_t S, int n,
                                    int win_h, int win_w, float* scores,
                                    void* stream) {
  (void)grad;
  const unsigned int blocks = (unsigned int)((B + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * 2 * (size_t)n * sizeof(float);
  window_ncc_warp_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      stack, rows, width, row0, x0, xs, ys, B, M, S, n, win_h, win_w, scores);
  return (int)cudaGetLastError();
}
