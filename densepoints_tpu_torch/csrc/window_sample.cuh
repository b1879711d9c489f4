// Device code shared by the two window kernels (window_ncc.cu,
// window_textures.cu): window-relative bilinear sampling by a whole warp
// with every tap of a texture in flight, the switches that turn one cost
// centre of it off, and the texel-by-texel form of the block body that the
// `block` and `staged` variants keep.
//
// Sampling contract: a texel at (x, y) inside a win_h x win_w window whose
// corner is (row0, x0) of a row-major image of `rows` x `width` f32 takes
// the taps (floor(y) + {0, 1}, floor(x) + {0, 1}) with the hat weights
// max(0, 1 - |y - row|) and max(0, 1 - |x - col|), blended per row as
// left + fx * (right - left). A tap outside the window, or outside the
// image, contributes zero; nothing is clamped. With a gradient image the
// blend is left + fx * grad[row, floor(x)]: two taps of each image per row.

#pragma once

#include "warp_ncc_common.cuh"

namespace window {

// ---------------------------------------------------------------------------
// The warp body: a warp samples one slot's texture, a lane T texels of it.

enum Switch {  // bits: kBare sets both
  kFull = 0,
  kNoLoad = 1,    // taps computed from the coordinates: no load of the image
  kNoReduce = 2,  // no warp shuffle: each lane keeps its own partial sums
  kBare = 3,      // neither taps nor shuffles: what is left
};

// Warps of a block of the warp body (a slot or a patch each; no block
// barrier).
constexpr int kWinWarps = 4;

// Texels a lane holds in registers, T = ceil(n / 32) rounded up to a power
// of two, for textures of up to 256 texels; 0 = chunks of 256 (T = 8 each).
__host__ __device__ inline int window_texels(int n) {
  return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : n <= 256 ? 8 : 0;
}

// Whether the coordinates may be read as float4: every row of S floats
// starts 16-byte aligned.
inline bool vector_rows(const float* xs, const float* ys, int64_t S) {
  return S % 4 == 0 && ((uintptr_t)xs | (uintptr_t)ys) % 16 == 0;
}

// Which texel lane `lane` holds in register j. With float4 coordinate loads
// (kVec, T = 4 or 8) a lane holds four neighbours, texels 128 q + 4 lane + e
// for j = 4 q + e; otherwise texels lane + 32 j. Every slot of a launch uses
// one mapping, so a texel sits in the same lane and register in all of them.
template <bool kVec>
__device__ __forceinline__ int texel_index(int lane, int j) {
  return kVec ? 128 * (j >> 2) + 4 * lane + (j & 3) : lane + 32 * j;
}

// The T coordinate pairs of a lane from a slot's rows px, py (texels past
// n read as 0 and are masked later). kVec needs px, py 16-byte aligned.
template <int T, bool kVec>
__device__ __forceinline__ void load_coords(const float* __restrict__ px,
                                            const float* __restrict__ py,
                                            int n, int lane, float (&x)[T],
                                            float (&y)[T]) {
  if constexpr (kVec) {
    static_assert(T % 4 == 0, "float4 loads need 4 texels per group");
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      // The row holds S >= n floats with S a multiple of 4, so a group that
      // starts before n lies inside the row.
      const int i = 128 * q + 4 * lane;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (i < n) {
        a = __ldg(reinterpret_cast<const float4*>(px + i));
        b = __ldg(reinterpret_cast<const float4*>(py + i));
      }
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z,
      x[4 * q + 3] = a.w;
      y[4 * q] = b.x, y[4 * q + 1] = b.y, y[4 * q + 2] = b.z,
      y[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int i = lane + 32 * j;
      x[j] = i < n ? __ldg(px + i) : 0.f;
      y[j] = i < n ? __ldg(py + i) : 0.f;
    }
  }
}

// One slot's window: its corner as a pointer into the image (and into the
// gradient image), and the taps that lie inside the image as the half-open
// ranges [r_lo, r_lo + nr) x [c_lo, c_lo + nc) of window rows and columns.
// A tap's offset from the corner is 32-bit: the wrappers keep
// (win_h + 2) * width + win_w + 2 below 2^31.
struct Window {
  const float* img;   // may point outside the image; only taps inside are read
  const float* grad;  // kGrad only
  int stride;         // the image's row length
  int r_lo, nr, c_lo, nc;
  float hmax, wmax;   // win_h, win_w as floats: the clamp of a tap's corner
};

__device__ __forceinline__ Window make_window(const float* img,
                                              const float* grad, int64_t rows,
                                              int64_t width, int64_t row0,
                                              int64_t x0, int win_h,
                                              int win_w) {
  Window w;
  const int64_t corner = row0 * width + x0;
  w.img = img + corner;
  w.grad = grad ? grad + corner : nullptr;
  w.stride = (int)width;
  const int64_t r_lo = row0 < 0 ? -row0 : 0;
  const int64_t c_lo = x0 < 0 ? -x0 : 0;
  const int64_t r_hi = rows - row0 < win_h ? rows - row0 : win_h;
  const int64_t c_hi = width - x0 < win_w ? width - x0 : win_w;
  // A window wholly outside the image gives an empty range (nr or nc 0).
  w.r_lo = (int)(r_lo < win_h ? r_lo : win_h);
  w.c_lo = (int)(c_lo < win_w ? c_lo : win_w);
  w.nr = r_hi > w.r_lo ? (int)(r_hi - w.r_lo) : 0;
  w.nc = c_hi > w.c_lo ? (int)(c_hi - w.c_lo) : 0;
  w.hmax = (float)win_h;
  w.wmax = (float)win_w;
  return w;
}

__device__ __forceinline__ bool in_range(int v, int lo, int count) {
  return (unsigned)(v - lo) < (unsigned)count;
}

// The 4 T taps of a lane's T texels and the texels' fractions.
template <int T>
struct Taps {
  float t00[T], t01[T], t10[T], t11[T], fx[T], fy[T];
};

// Every coordinate turned into its cell, then all 4 T taps issued; nothing
// here waits for a tap. With kGrad t01, t11 are the rows' steps from the
// gradient image (two taps of each image per row).
template <int T, int kSwitch, bool kGrad>
__device__ __forceinline__ void gather(const Window& w, const float (&x)[T],
                                       const float (&y)[T], Taps<T>& t) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float xf = floorf(x[j]), yf = floorf(y[j]);
    t.fx[j] = x[j] - xf;
    t.fy[j] = y[j] - yf;
    // Clamped before the conversion, so a NaN or a huge coordinate becomes
    // a tap outside the window and never wraps into it.
    const int ix = (int)fminf(fmaxf(xf, -2.f), w.wmax);
    const int iy = (int)fminf(fmaxf(yf, -2.f), w.hmax);
    if (kSwitch & kNoLoad) {  // as many operations, no load
      t.t00[j] = t.fx[j] + (float)iy;
      t.t01[j] = t.fy[j] - (float)ix;
      t.t10[j] = t.fx[j] - (float)iy;
      t.t11[j] = t.fy[j] + (float)ix;
      continue;
    }
    const bool r0 = in_range(iy, w.r_lo, w.nr);
    const bool r1 = in_range(iy + 1, w.r_lo, w.nr);
    const bool c0 = in_range(ix, w.c_lo, w.nc);
    const bool c1 = in_range(ix + 1, w.c_lo, w.nc);
    const int off = iy * w.stride + ix;
    t.t00[j] = r0 && c0 ? __ldg(w.img + off) : 0.f;
    t.t10[j] = r1 && c0 ? __ldg(w.img + off + w.stride) : 0.f;
    if (kGrad) {
      t.t01[j] = r0 && c0 ? __ldg(w.grad + off) : 0.f;
      t.t11[j] = r1 && c0 ? __ldg(w.grad + off + w.stride) : 0.f;
    } else {
      t.t01[j] = r0 && c1 ? __ldg(w.img + off + 1) : 0.f;
      t.t11[j] = r1 && c1 ? __ldg(w.img + off + w.stride + 1) : 0.f;
    }
  }
}

// The taps blended into T texels: left + fx * step per row, then the rows.
template <int T, bool kGrad>
__device__ __forceinline__ void blend(const Taps<T>& t, float (&tex)[T]) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float top = kGrad ? fmaf(t.fx[j], t.t01[j], t.t00[j])
                            : fmaf(t.fx[j], t.t01[j] - t.t00[j], t.t00[j]);
    const float bot = kGrad ? fmaf(t.fx[j], t.t11[j], t.t10[j])
                            : fmaf(t.fx[j], t.t11[j] - t.t10[j], t.t10[j]);
    tex[j] = fmaf(t.fy[j], bot - top, top);
  }
}

template <int T, int kSwitch, bool kGrad>
__device__ __forceinline__ void sample(const Window& w, const float (&x)[T],
                                       const float (&y)[T], float (&tex)[T]) {
  Taps<T> t;
  gather<T, kSwitch, kGrad>(w, x, y, t);
  blend<T, kGrad>(t, tex);
}

// K sums over the warp at once, shuffles interleaved, or (kNoReduce) each
// lane's own values.
template <int kSwitch, int K>
__device__ __forceinline__ void reduce(float (&v)[K]) {
  if (kSwitch & kNoReduce) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] += __shfl_xor_sync(warp_ncc::kFullMask, v[k], o);
    }
  }
}

// ---------------------------------------------------------------------------
// The block body (`block`, `staged`): one block per slot or patch, a thread
// per texel, reductions over the block. Kept as it was first written, to be
// timed beside the warp body.

using warp_ncc::kThreads;  // threads of a block

// One slot's window for the block body, corner and in-image tap ranges
// [r_lo, r_hi) x [c_lo, c_hi), tap offsets in 64 bits.
struct BlockWindow {
  int64_t row0, x0;
  int r_lo, r_hi, c_lo, c_hi;
};

__device__ __forceinline__ BlockWindow make_block_window(
    int64_t row0, int64_t x0, int64_t rows, int64_t width, int win_h,
    int win_w) {
  BlockWindow w;
  w.row0 = row0;
  w.x0 = x0;
  const int64_t r_lo = row0 < 0 ? -row0 : 0;
  const int64_t c_lo = x0 < 0 ? -x0 : 0;
  const int64_t r_hi = rows - row0 < win_h ? rows - row0 : win_h;
  const int64_t c_hi = width - x0 < win_w ? width - x0 : win_w;
  // An empty range (window wholly outside) keeps lo >= hi within int.
  w.r_lo = (int)(r_lo < win_h ? r_lo : win_h);
  w.c_lo = (int)(c_lo < win_w ? c_lo : win_w);
  w.r_hi = (int)(r_hi > 0 ? r_hi : 0);
  w.c_hi = (int)(c_hi > 0 ? c_hi : 0);
  return w;
}

__device__ __forceinline__ float tap(const float* __restrict__ img,
                                     int64_t width, const BlockWindow& w,
                                     int r, int c) {
  const bool ok = r >= w.r_lo && r < w.r_hi && c >= w.c_lo && c < w.c_hi;
  return ok ? __ldg(img + (w.row0 + r) * width + (w.x0 + c)) : 0.f;
}

// The whole window into shared memory, zeros where it leaves the image:
// thread t takes columns t, t + kThreads, ... of each row, so every load
// is a coalesced line. Ends with a block barrier.
__device__ __forceinline__ void stage_window(const float* __restrict__ img,
                                             int64_t width,
                                             const BlockWindow& w, int win_h,
                                             int win_w,
                                             float* __restrict__ win) {
#pragma unroll 4
  for (int r = 0; r < win_h; ++r) {
    for (int c = threadIdx.x; c < win_w; c += kThreads) {
      win[r * win_w + c] = tap(img, width, w, r, c);
    }
  }
  __syncthreads();
}

// One texel of the block body; `win` is the staged window (kStaged only).
template <bool kStaged>
__device__ __forceinline__ float block_texel(const float* __restrict__ img,
                                             const float* __restrict__ win,
                                             int64_t width,
                                             const BlockWindow& w, int win_h,
                                             int win_w, float x, float y) {
  const float xf = floorf(x), yf = floorf(y);
  const float fx = x - xf, fy = y - yf;
  const int ix = (int)fminf(fmaxf(xf, -2.f), (float)win_w);
  const int iy = (int)fminf(fmaxf(yf, -2.f), (float)win_h);
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int r = iy + dy;
    const float wy = dy ? fy : 1.f - fy;
    float left, right;
    if (kStaged) {
      const bool rok = r >= 0 && r < win_h;
      const float* row = win + r * win_w;
      left = (rok && ix >= 0 && ix < win_w) ? row[ix] : 0.f;
      right = (rok && ix + 1 >= 0 && ix + 1 < win_w) ? row[ix + 1] : 0.f;
    } else {
      left = tap(img, width, w, r, ix);
      right = tap(img, width, w, r, ix + 1);
    }
    acc += wy * (left + fx * (right - left));
  }
  return acc;
}

}  // namespace window
