// Centred window-relative textures per slot, with ablation variants, for
// Hopper (sm_90a).
//
// Replaces the TPU ablation kernel scripts/kernel_paged_ablate.py
// `make_call`, the first half of the all-views scoring pass: slot s samples
// n texels at (xs, ys)[s, :n] inside the win_h-row window at row row0[s] of
// page page[s] of a (P, R, W) page stack (the window spans the page's
// width; window_sample.cuh has the sampling contract), subtracts the
// texture's mean and writes out[s, :n]. A dead slot (page outside [0, P))
// gets zeros.
//
// Not carried over from the TPU kernel: the one-hot "hat" matmuls and the
// wider dots of `fused`, `pack2` and `pack4`, the step / row / group layout
// (one page per 128-slot step), the 128-lane padding, the 8-row alignment
// of row0, bf16 pages, and rows of a dead step left unwritten. Its variants
// probe MXU width; the variants here switch off what costs time on this card.
//
// What bounds it on the H100: the bound counts bytes (8 B of coordinates in
// and 4 B out per texel, at most 16 B of page per texel). What holds it
// back is the taps: each texel's two rows are two 32-byte sectors that L1
// rarely holds, so L2 delivers 64-72 B per texel (PERF.md). The design
// therefore keeps every tap in flight and lets L1 catch what neighbouring
// slots share: one warp per slot and no block barrier; a lane reads all its
// coordinates (as float4 where the rows allow), then issues all 4 T taps,
// then blends; the mean is a warp shuffle; the centred texture goes from
// registers to `out`, with no shared memory; a dead slot's warp writes zeros
// and leaves. Up to 128 texels a slot, each SM runs one block of 32 warps
// over one run of neighbouring slots, so that the slots in flight on an SM
// share pages (as a step of the TPU layout does) and L1 serves their
// common taps.
//   full      the body above;
//   noload    taps computed from the coordinates, no load of the pages;
//   noreduce  taps gathered, no shuffle: the raw texture is written;
//   bare      `noload` and `noreduce` together: what is left;
//   block     the first body (one block per slot, a thread per texel, the
//             texture through shared memory, a block reduction);
//   staged    `block` that first copies the slot's window to shared memory.
// `noload`, `noreduce` and `bare` no longer compute the textures; they only
// bound a cost. The others compute the same textures.

#include "window_sample.cuh"

namespace {

using namespace warp_ncc;
using namespace window;

// Warps of a block that takes a run of N / SMs slots: all an SM holds at up
// to 64 registers a thread.
constexpr int kRunWarps = 32;

// What every launch of the warp body carries.
struct Args {
  const float* pages;
  int64_t P, R, W;
  const int* page;
  const int* row0;
  const float* xs;
  const float* ys;
  int64_t N, S;
  int n, win_h;
  float* out;
};

// Slot `slot` by one whole warp. T = texels per lane, 0 = chunks of 256
// (T = 8 each): the raw texture goes to `out` and each lane centres what it
// wrote itself.
template <int kSwitch, int T, bool kVec>
__device__ __forceinline__ void centre_slot(const Args& a, int64_t slot,
                                            int lane) {
  const int n = a.n;
  float* orow = a.out + slot * n;
  const int pg = a.page[slot];  // uniform over the warp
  if (pg < 0 || pg >= a.P) {
    for (int i = lane; i < n; i += 32) orow[i] = 0.f;
    return;
  }
  const Window w = make_window(a.pages + (int64_t)pg * a.R * a.W, nullptr,
                               a.R, a.W, a.row0[slot], 0, a.win_h, (int)a.W);
  const float* px = a.xs + slot * a.S;
  const float* py = a.ys + slot * a.S;
  const float nf = (float)n;
  if constexpr (T > 0) {
    float x[T], y[T], tex[T];
    load_coords<T, kVec>(px, py, n, lane, x, y);
    sample<T, kSwitch, false>(w, x, y, tex);
    float sum[1] = {0.f};
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (texel_index<kVec>(lane, j) >= n) tex[j] = 0.f;
      sum[0] += tex[j];
    }
    reduce<kSwitch>(sum);
    const float mean = (kSwitch & kNoReduce) ? 0.f : sum[0] / nf;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      // Rows of n = 121 floats are not 16-byte aligned: scalar stores.
      const int i = texel_index<kVec>(lane, j);
      if (i < n) orow[i] = tex[j] - mean;
    }
  } else {
    float sum[1] = {0.f};
    for (int c = 0; c < n; c += 256) {
      float x[8], y[8], tex[8];
      load_coords<8, false>(px + c, py + c, n - c, lane, x, y);
      sample<8, kSwitch, false>(w, x, y, tex);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = c + lane + 32 * j;
        if (i < n) {
          orow[i] = tex[j];
          sum[0] += tex[j];
        }
      }
    }
    if (kSwitch & kNoReduce) return;
    reduce<kSwitch>(sum);
    const float mean = sum[0] / nf;
    // Each lane reads back only what it wrote itself.
    for (int i = lane; i < n; i += 32) orow[i] -= mean;
  }
}

// Block b of gridDim.x takes the b-th of gridDim.x equal runs of
// neighbouring slots, and its kW warps walk the run kW slots at a time.
template <int kSwitch, int T, bool kVec, int kW>
__global__ void __launch_bounds__(kW * 32, kW == kRunWarps ? 1 : 4)
    window_textures_kernel(Args a) {
  const int64_t run = (a.N + gridDim.x - 1) / gridDim.x;
  const int64_t start = (int64_t)blockIdx.x * run;
  const int64_t end = start + run < a.N ? start + run : a.N;
  const int lane = threadIdx.x & 31;
  // Whole warps leave; nobody waits for them.
  for (int64_t slot = start + (threadIdx.x >> 5); slot < end; slot += kW) {
    centre_slot<kSwitch, T, kVec>(a, slot, lane);
  }
}

// Block body: one block per slot, kThreads threads.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    window_textures_block_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n, win_h = a.win_h, win_w = (int)a.W;
  float* tex = smem;      // the slot's texture (n)
  float* win = smem + n;  // the staged window (kStaged only)
  __shared__ float2 part[warp_ncc::kWarps];
  __shared__ float2 total;

  const int64_t slot = blockIdx.x;
  const int tid = threadIdx.x;
  float* orow = a.out + slot * n;
  const int pg = a.page[slot];  // uniform over the block
  if (pg < 0 || pg >= a.P) {
    for (int i = tid; i < n; i += kThreads) orow[i] = 0.f;
    return;
  }
  const float* img = a.pages + (int64_t)pg * a.R * a.W;
  const BlockWindow w =
      make_block_window(a.row0[slot], 0, a.R, a.W, win_h, win_w);
  if (kStaged) stage_window(img, a.W, w, win_h, win_w, win);
  const float* px = a.xs + slot * a.S;
  const float* py = a.ys + slot * a.S;
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float t =
        block_texel<kStaged>(img, win, a.W, w, win_h, win_w, px[i], py[i]);
    tex[i] = t;
    s += t;
  }
  const float mean = block_sum2(s, 0.f, part, &total).x / (float)n;
  for (int i = tid; i < n; i += kThreads) orow[i] = tex[i] - mean;
}

// Up to 128 texels a slot: one block of kRunWarps warps per SM, each a run
// of N / SMs slots. Above: blocks of kWinWarps warps, each a run of
// kWinWarps slots (the registers of T = 8 do not fit 32 warps an SM).
template <int kSwitch>
int launch_warp(const Args& a, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int texels = window_texels(a.n);
  const bool runs = texels > 0 && texels <= 4;
  const unsigned int grid =
      runs ? (unsigned int)sms
           : (unsigned int)((a.N + kWinWarps - 1) / kWinWarps);
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vector_rows(a.xs, a.ys, a.S);
#define LAUNCH(T, V, WARPS) \
  window_textures_kernel<kSwitch, T, V, WARPS><<<grid, WARPS * 32, 0, st>>>(a)
  switch (texels) {
    case 1: LAUNCH(1, false, kRunWarps); break;
    case 2: LAUNCH(2, false, kRunWarps); break;
    case 4:
      if (vec) LAUNCH(4, true, kRunWarps);
      else LAUNCH(4, false, kRunWarps);
      break;
    case 8:
      if (vec) LAUNCH(8, true, kWinWarps);
      else LAUNCH(8, false, kWinWarps);
      break;
    default: LAUNCH(0, false, kWinWarps); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <bool kStaged>
int launch_block(const Args& a, void* stream) {
  size_t floats = (size_t)a.n;
  if (kStaged) floats += (size_t)a.win_h * (size_t)a.W;
  window_textures_block_kernel<kStaged>
      <<<(unsigned int)a.N, kThreads, floats * sizeof(float),
         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per variant, all with one signature.
#define WINDOW_TEXTURES_LAUNCHER(name, call)                                 \
  extern "C" int name(const float* pages, int64_t P, int64_t R, int64_t W,   \
                      const int* page, const int* row0, const float* xs,     \
                      const float* ys, int64_t N, int64_t S, int n,          \
                      int win_h, float* out, void* stream) {                 \
    const Args a{pages, P, R, W, page, row0, xs, ys, N, S, n, win_h, out};   \
    return call(a, stream);                                                  \
  }

WINDOW_TEXTURES_LAUNCHER(window_textures_full, launch_warp<window::kFull>)
WINDOW_TEXTURES_LAUNCHER(window_textures_noload, launch_warp<window::kNoLoad>)
WINDOW_TEXTURES_LAUNCHER(window_textures_noreduce,
                         launch_warp<window::kNoReduce>)
WINDOW_TEXTURES_LAUNCHER(window_textures_bare, launch_warp<window::kBare>)
WINDOW_TEXTURES_LAUNCHER(window_textures_block, launch_block<false>)
WINDOW_TEXTURES_LAUNCHER(window_textures_staged, launch_block<true>)
