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
// what costs time on this card.
//
// What bounds it on the H100: the bound counts bytes (8 B of coordinates
// and at most 16 B of stack per texel, one f32 out per slot). What holds it
// back is the taps: each texel's two rows are two 32-byte sectors that L1
// rarely holds, so L2 delivers 64-72 B per texel (PERF.md). The design, as
// K1's (allview_ncc.cu), keeps as many of them in flight as it can: one
// warp per patch and no block barrier; slot 0's texture is sampled into
// registers and kept there centred, in the same lane and register as the
// same texel of every later slot; up to 128 texels the slots go two at a
// time, both textures' taps issued together (8 T in flight), the next two
// slots' coordinates (as float4 where the rows allow) and corners read
// behind them, then mean, variance and covariance from registers, each in
// one interleaved set of warp shuffles for both slots. Above 128 texels the
// slots go one at a time, and above 256 the centred slot 0 is kept in
// shared memory and each slot is sampled twice, 256 texels at a time.
//   full      the body above;
//   noload    taps computed from the coordinates, no load of the stack:
//             what the gathers cost;
//   noreduce  taps gathered, but every lane keeps its own partial sums:
//             what the shuffles cost;
//   bare      `noload` and `noreduce` together: the coordinate reads, the
//             arithmetic and the walk over the slots that are left;
//   block     the first body (one block per patch walks its M slots, a
//             thread per texel, textures through shared memory, two block
//             reductions per slot);
//   staged    `block` that first copies each slot's window to shared memory
//             with coalesced loads and takes its taps there.
// `noload`, `noreduce` and `bare` no longer compute the scores; they only
// bound a cost. The others compute the same scores.

#include "window_sample.cuh"

namespace {

using namespace warp_ncc;
using namespace window;

constexpr float kNever = -12345.f;  // no score takes this value

struct Args {
  const float* stack;
  const float* grad;
  int64_t rows, width;
  const int* row0;
  const int* x0;
  const float* xs;
  const float* ys;
  int64_t B, M, S;
  int n, win_h, win_w;
  float* scores;

  __device__ Window window(int64_t corner_row, int64_t corner_col) const {
    return make_window(stack, grad, rows, width, corner_row, corner_col,
                       win_h, win_w);
  }
};

// Lane 0 writes the score; with kNoReduce every lane holds its own, and the
// comparison keeps every lane's work alive.
template <int kSwitch>
__device__ __forceinline__ void write_score(float* p, float score, int lane) {
  if (lane == 0 || ((kSwitch & kNoReduce) && score == kNever)) *p = score;
}

// Warp body, T = 1, 2, 4, 8 texels per lane: the slots kPer at a time, the
// taps of a group's slots issued together, the next group's coordinates
// and corners behind them, then the blends and all the group's sums in one
// interleaved set of shuffles.
template <int kSwitch, bool kGrad, int T, bool kVec, int kPer>
__device__ __forceinline__ void score_patch(const Args& a, int64_t b,
                                            int lane) {
  const float nf = (float)a.n;
  bool valid[T];
#pragma unroll
  for (int j = 0; j < T; ++j) valid[j] = texel_index<kVec>(lane, j) < a.n;
  const int64_t first = b * a.M;
  // A group's coordinates and corners are read one group ahead; its window
  // is formed when its taps are issued.
  float x[kPer][T], y[kPer][T], ca[T];
  int row0[kPer], x0[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (p < a.M) {
      const int64_t slot = first + p;
      load_coords<T, kVec>(a.xs + slot * a.S, a.ys + slot * a.S, a.n, lane,
                           x[p], y[p]);
      row0[p] = a.row0[slot];
      x0[p] = a.x0[slot];
    }
  }
  float va = 0.f;
  for (int64_t m = 0; m < a.M; m += kPer) {
    Taps<T> taps[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (m + p < a.M) {
        gather<T, kSwitch, kGrad>(a.window(row0[p], x0[p]), x[p], y[p],
                                  taps[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int64_t slot = first + m + kPer + p;
      if (m + kPer + p < a.M) {
        load_coords<T, kVec>(a.xs + slot * a.S, a.ys + slot * a.S, a.n, lane,
                             x[p], y[p]);
        row0[p] = a.row0[slot];
        x0[p] = a.x0[slot];
      }
    }
    float tex[kPer][T], sum[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      sum[p] = 0.f;
      if (m + p < a.M) blend<T, kGrad>(taps[p], tex[p]);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (!valid[j] || m + p >= a.M) tex[p][j] = 0.f;
        sum[p] += tex[p][j];
      }
    }
    reduce<kSwitch>(sum);
    // var and cov of each slot of the group, interleaved for one reduction;
    // slot 0 is centred first, and is its own covariance.
    float vc[2 * kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float mean = sum[p] / nf;
      float var = 0.f, cov = 0.f;
      if (m == 0 && p == 0) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          ca[j] = valid[j] ? tex[0][j] - mean : 0.f;
          var = fmaf(ca[j], ca[j], var);
        }
        cov = var;
      } else {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          // ca is 0 past the texture's end; the variance needs the mask.
          const float d = valid[j] ? tex[p][j] - mean : 0.f;
          var = fmaf(d, d, var);
          cov = fmaf(d, ca[j], cov);
        }
      }
      vc[2 * p] = var;
      vc[2 * p + 1] = cov;
    }
    reduce<kSwitch>(vc);
    if (m == 0) va = vc[0] / nf;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (m + p < a.M) {
        const float vt = vc[2 * p] / nf;
        write_score<kSwitch>(
            a.scores + first + m + p,
            (vc[2 * p + 1] / nf) / fmaxf(sqrtf(va) * sqrtf(vt), 0.1f), lane);
      }
    }
  }
}

// Warp body above 256 texels: slot 0 centred in shared memory (`ca`, n
// words of this warp), every slot sampled twice, 256 texels at a time.
template <int kSwitch, bool kGrad>
__device__ __forceinline__ void score_patch_strided(const Args& a, int64_t b,
                                                    int lane, float* ca) {
  const float nf = (float)a.n;
  float va = 0.f;
  for (int64_t m = 0; m < a.M; ++m) {
    const int64_t slot = b * a.M + m;
    const Window w = a.window(a.row0[slot], a.x0[slot]);
    const float* px = a.xs + slot * a.S;
    const float* py = a.ys + slot * a.S;
    float x[8], y[8], tex[8];
    float sum[1] = {0.f};
    for (int c = 0; c < a.n; c += 256) {
      load_coords<8, false>(px + c, py + c, a.n - c, lane, x, y);
      sample<8, kSwitch, kGrad>(w, x, y, tex);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c + lane + 32 * j < a.n) sum[0] += tex[j];
      }
    }
    reduce<kSwitch>(sum);
    const float mean = sum[0] / nf;
    float vc[2] = {0.f, 0.f};
    for (int c = 0; c < a.n; c += 256) {
      load_coords<8, false>(px + c, py + c, a.n - c, lane, x, y);
      sample<8, kSwitch, kGrad>(w, x, y, tex);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = c + lane + 32 * j;
        if (i < a.n) {
          const float d = tex[j] - mean;
          if (m == 0) ca[i] = d;  // read back by this lane only
          vc[0] = fmaf(d, d, vc[0]);
          vc[1] = fmaf(d, ca[i], vc[1]);
        }
      }
    }
    reduce<kSwitch>(vc);
    const float vt = vc[0] / nf;
    if (m == 0) va = vt;
    write_score<kSwitch>(a.scores + slot,
                         (vc[1] / nf) / fmaxf(sqrtf(va) * sqrtf(vt), 0.1f),
                         lane);
  }
}

// Slots in flight together per warp: two up to 128 texels, one above
// (the registers of two T = 8 groups would spill).
__host__ __device__ constexpr int group_slots(int T) {
  return T > 0 && T <= 4 ? 2 : 1;
}

template <int kSwitch, bool kGrad, int T, bool kVec>
__global__ void __launch_bounds__(kWinWarps * 32, 4)
    window_ncc_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWinWarps + warp;
  if (b >= a.B) return;  // whole warps leave; nobody waits for them
  if constexpr (T > 0) {
    score_patch<kSwitch, kGrad, T, kVec, group_slots(T)>(a, b, lane);
  } else {
    score_patch_strided<kSwitch, kGrad>(a, b, lane, smem + warp * a.n);
  }
}

// Block body: one block per patch walks its M slots.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) window_ncc_block_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n, win_h = a.win_h, win_w = a.win_w;
  float* ca = smem;           // slot 0's texture, centred (n)
  float* tex = smem + n;      // current slot's texture (n)
  float* win = smem + 2 * n;  // the staged window (kStaged only)
  __shared__ float2 part[warp_ncc::kWarps];
  __shared__ float2 total;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const float nf = (float)n;
  float va = 0.f;
  for (int64_t m = 0; m < a.M; ++m) {
    const int64_t slot = b * a.M + m;
    const BlockWindow w = make_block_window(a.row0[slot], a.x0[slot], a.rows,
                                            a.width, win_h, win_w);
    // The taps of the slot before were all taken before its reductions'
    // barriers, so the window may be overwritten here.
    if (kStaged) stage_window(a.stack, a.width, w, win_h, win_w, win);
    const float* px = a.xs + slot * a.S;
    const float* py = a.ys + slot * a.S;
    float s = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float t = block_texel<kStaged>(a.stack, win, a.width, w, win_h,
                                           win_w, px[i], py[i]);
      tex[i] = t;
      s += t;
    }
    const float mean = block_sum2(s, 0.f, part, &total).x / nf;
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
    const float2 qc = block_sum2(q, cv, part, &total);
    const float vt = qc.x / nf;
    if (m == 0) va = vt;
    if (tid == 0) {
      a.scores[slot] = (qc.y / nf) / fmaxf(sqrtf(va) * sqrtf(vt), 0.1f);
    }
  }
}

template <int kSwitch, bool kGrad>
int launch_warp(const Args& a, void* stream) {
  const unsigned int grid = (unsigned int)((a.B + kWinWarps - 1) / kWinWarps);
  const int texels = window_texels(a.n);
  // The strided form keeps slot 0's centred texture, n words per warp.
  const size_t smem =
      texels == 0 ? (size_t)kWinWarps * a.n * sizeof(float) : 0;
  const bool vec = vector_rows(a.xs, a.ys, a.S);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                        \
  window_ncc_kernel<kSwitch, kGrad, T, V><<<grid, kWinWarps * 32, smem, st>>>(a)
  switch (texels) {
    case 1: LAUNCH(1, false); break;
    case 2: LAUNCH(2, false); break;
    case 4: if (vec) LAUNCH(4, true); else LAUNCH(4, false); break;
    case 8: if (vec) LAUNCH(8, true); else LAUNCH(8, false); break;
    default: LAUNCH(0, false); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <bool kStaged>
int launch_block(const Args& a, void* stream) {
  size_t floats = 2 * (size_t)a.n;
  if (kStaged) floats += (size_t)a.win_h * (size_t)a.win_w;
  window_ncc_block_kernel<kStaged>
      <<<(unsigned int)a.B, kThreads, floats * sizeof(float),
         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per variant, all with one signature. `grad` is read by the
// grad launchers only and may be null for the others.
#define WINDOW_NCC_LAUNCHER(name, call)                                      \
  extern "C" int name(const float* stack, const float* grad, int64_t rows,   \
                      int64_t width, const int* row0, const int* x0,         \
                      const float* xs, const float* ys, int64_t B,           \
                      int64_t M, int64_t S, int n, int win_h, int win_w,     \
                      float* scores, void* stream) {                         \
    const Args a{stack, grad, rows, width, row0, x0,    xs,                 \
                 ys,    B,    M,    S,     n,    win_h, win_w, scores};      \
    return call(a, stream);                                                  \
  }

WINDOW_NCC_LAUNCHER(window_ncc_full, (launch_warp<window::kFull, false>))
WINDOW_NCC_LAUNCHER(window_ncc_noload, (launch_warp<window::kNoLoad, false>))
WINDOW_NCC_LAUNCHER(window_ncc_noreduce,
                    (launch_warp<window::kNoReduce, false>))
WINDOW_NCC_LAUNCHER(window_ncc_bare, (launch_warp<window::kBare, false>))
WINDOW_NCC_LAUNCHER(window_ncc_block, launch_block<false>)
WINDOW_NCC_LAUNCHER(window_ncc_staged, launch_block<true>)
WINDOW_NCC_LAUNCHER(window_ncc_grad_full, (launch_warp<window::kFull, true>))
WINDOW_NCC_LAUNCHER(window_ncc_grad_noload,
                    (launch_warp<window::kNoLoad, true>))
WINDOW_NCC_LAUNCHER(window_ncc_grad_noreduce,
                    (launch_warp<window::kNoReduce, true>))
