// Centred window-relative textures per slot, with ablation variants, for
// Hopper (sm_90a).
//
// Replaces the TPU ablation kernel scripts/kernel_paged_ablate.py
// `make_call`, the first half of the all-views scoring pass: slot s samples
// n texels at (xs, ys)[s, :n] inside the win_h-row window at row row0[s] of
// page page[s] of a (P, R, W) page stack (the window spans the page's
// width; window_sample.cuh has the sampling contract), subtracts the
// texture's mean and writes out[s, :n]. A dead slot (page < 0) gets zeros.
//
// Not carried over from the TPU kernel: the one-hot "hat" matmuls and the
// wider dots of `fused`, `pack2` and `pack4`, the step / row / group layout
// (one page per 128-slot step), the 128-lane padding, the 8-row alignment
// of row0, bf16 pages, and rows of a dead step left unwritten. Its variants
// probe MXU width; the variants here switch off what costs time on this card:
//   full      gathered taps, one block reduction, one block per slot;
//   noload    taps computed from the coordinates, no load of the pages;
//   noreduce  taps gathered, no reduction: the raw texture is written;
//   bare      `noload` and `noreduce` together: what is left;
//   staged    the block first copies the slot's window into shared memory;
//   warp_slot one warp per slot (four slots per block), the mean by
//             shuffle only, no block barrier.
// `noload`, `noreduce` and `bare` no longer compute the textures; they only
// bound a cost. The others compute the same textures.
//
// What bounds it on the H100: bytes by the count (8 B of coordinates in and
// 4 B out per texel, at most 16 B of page per texel); the variants exist to
// say what the kernel spends above that.

#include "window_sample.cuh"

namespace {

using namespace warp_ncc;
using namespace window;

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    window_textures_kernel(const float* __restrict__ pages, int64_t P,
                           int64_t R, int64_t W,
                           const int* __restrict__ page,
                           const int* __restrict__ row0,
                           const float* __restrict__ xs,
                           const float* __restrict__ ys, int64_t S, int n,
                           int win_h, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tex = smem;      // the slot's texture (n)
  float* win = smem + n;  // the staged window (kStaged only)
  __shared__ float2 part[kWarps];
  __shared__ float2 total;

  const int64_t slot = blockIdx.x;
  const int tid = threadIdx.x;
  float* orow = out + slot * n;
  const int pg = page[slot];  // uniform over the block
  if (pg < 0 || pg >= P) {
    for (int i = tid; i < n; i += kThreads) orow[i] = 0.f;
    return;
  }
  const float* img = pages + (int64_t)pg * R * W;
  const int win_w = (int)W;
  const Window w = make_window(row0[slot], 0, R, W, win_h, win_w);
  if (kVariant == kStaged) stage_window(img, W, w, win_h, win_w, win);
  const float* px = xs + slot * S;
  const float* py = ys + slot * S;
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float t = texel<kVariant, false>(img, nullptr, win, W, w, win_h,
                                           win_w, px[i], py[i]);
    tex[i] = t;
    s += t;
  }
  float mean = 0.f;
  if (!(kVariant & kNoReduce)) {
    mean = block_sum2(s, 0.f, part, &total).x / (float)n;
  }
  for (int i = tid; i < n; i += kThreads) orow[i] = tex[i] - mean;
}

// One warp per slot: warp j of a block takes slot 4 * blockIdx.x + j.
__global__ void __launch_bounds__(kThreads)
    window_textures_warp_kernel(const float* __restrict__ pages, int64_t P,
                                int64_t R, int64_t W,
                                const int* __restrict__ page,
                                const int* __restrict__ row0,
                                const float* __restrict__ xs,
                                const float* __restrict__ ys, int64_t N,
                                int64_t S, int n, int win_h,
                                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t slot = (int64_t)blockIdx.x * kWarps + warp;
  if (slot >= N) return;  // whole warps leave together; no block barrier
  float* tex = smem + (size_t)warp * n;
  float* orow = out + slot * n;
  const int pg = page[slot];
  if (pg < 0 || pg >= P) {
    for (int i = lane; i < n; i += 32) orow[i] = 0.f;
    return;
  }
  const float* img = pages + (int64_t)pg * R * W;
  const int win_w = (int)W;
  const Window w = make_window(row0[slot], 0, R, W, win_h, win_w);
  const float* px = xs + slot * S;
  const float* py = ys + slot * S;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float t = texel<kFull, false>(img, nullptr, nullptr, W, w, win_h,
                                        win_w, px[i], py[i]);
    tex[i] = t;
    s += t;
  }
  const float mean = warp_sum(s) / (float)n;
  for (int i = lane; i < n; i += 32) orow[i] = tex[i] - mean;
}

template <int kVariant>
int launch_block(const float* pages, int64_t P, int64_t R, int64_t W,
                 const int* page, const int* row0, const float* xs,
                 const float* ys, int64_t N, int64_t S, int n, int win_h,
                 float* out, void* stream) {
  size_t floats = (size_t)n;
  if (kVariant == kStaged) floats += (size_t)win_h * (size_t)W;
  window_textures_kernel<kVariant>
      <<<(unsigned int)N, kThreads, floats * sizeof(float),
         (cudaStream_t)stream>>>(pages, P, R, W, page, row0, xs, ys, S, n,
                                 win_h, out);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per variant, all with one signature.
#define WINDOW_TEXTURES_LAUNCHER(name, variant)                              \
  extern "C" int name(const float* pages, int64_t P, int64_t R, int64_t W,   \
                      const int* page, const int* row0, const float* xs,     \
                      const float* ys, int64_t N, int64_t S, int n,          \
                      int win_h, float* out, void* stream) {                 \
    return launch_block<variant>(pages, P, R, W, page, row0, xs, ys, N, S,   \
                                 n, win_h, out, stream);                     \
  }

WINDOW_TEXTURES_LAUNCHER(window_textures_full, window::kFull)
WINDOW_TEXTURES_LAUNCHER(window_textures_noload, window::kNoLoad)
WINDOW_TEXTURES_LAUNCHER(window_textures_noreduce, window::kNoReduce)
WINDOW_TEXTURES_LAUNCHER(window_textures_bare, window::kBare)
WINDOW_TEXTURES_LAUNCHER(window_textures_staged, window::kStaged)

extern "C" int window_textures_warp_slot(
    const float* pages, int64_t P, int64_t R, int64_t W, const int* page,
    const int* row0, const float* xs, const float* ys, int64_t N, int64_t S,
    int n, int win_h, float* out, void* stream) {
  const unsigned int blocks = (unsigned int)((N + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * (size_t)n * sizeof(float);
  window_textures_warp_kernel<<<blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
      pages, P, R, W, page, row0, xs, ys, N, S, n, win_h, out);
  return (int)cudaGetLastError();
}
