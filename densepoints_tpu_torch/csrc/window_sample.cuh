// Device code shared by the two ablation kernels (window_ncc.cu,
// window_textures.cu): window-relative bilinear sampling and the switches
// that turn one cost centre of it off.
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

using warp_ncc::kThreads;

enum Variant {  // kNoLoad and kNoReduce are bits: kBare sets both
  kFull = 0,      // gathered taps, block reductions
  kNoLoad = 1,    // taps computed from the coordinates: no load of the image
  kNoReduce = 2,  // gathered taps, each thread keeps its own partial sums
  kBare = 3,      // neither gathers nor reductions: what is left
  kStaged = 4,    // window copied to shared memory first, taps from there
};

// One slot's window: its corner and the part of it that lies inside the
// image, as half-open tap ranges [r_lo, r_hi) x [c_lo, c_hi).
struct Window {
  int64_t row0, x0;
  int r_lo, r_hi, c_lo, c_hi;
};

__device__ __forceinline__ Window make_window(int64_t row0, int64_t x0,
                                              int64_t rows, int64_t width,
                                              int win_h, int win_w) {
  Window w;
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
                                     int64_t width, const Window& w, int r,
                                     int c) {
  const bool ok = r >= w.r_lo && r < w.r_hi && c >= w.c_lo && c < w.c_hi;
  return ok ? __ldg(img + (w.row0 + r) * width + (w.x0 + c)) : 0.f;
}

// The whole window into shared memory, zeros where it leaves the image:
// thread t takes columns t, t + kThreads, ... of each row, so every load
// is a coalesced line. Ends with a block barrier.
__device__ __forceinline__ void stage_window(const float* __restrict__ img,
                                             int64_t width, const Window& w,
                                             int win_h, int win_w,
                                             float* __restrict__ win) {
#pragma unroll 4
  for (int r = 0; r < win_h; ++r) {
    for (int c = threadIdx.x; c < win_w; c += kThreads) {
      win[r * win_w + c] = tap(img, width, w, r, c);
    }
  }
  __syncthreads();
}

// One texel. `win` is the staged window (kStaged only); `grad` the gradient
// image (kGrad only).
template <int kVariant, bool kGrad>
__device__ __forceinline__ float texel(const float* __restrict__ img,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ win,
                                       int64_t width, const Window& w,
                                       int win_h, int win_w, float x,
                                       float y) {
  const float xf = floorf(x), yf = floorf(y);
  const float fx = x - xf, fy = y - yf;
  // Clamped before the conversion, so a NaN or a huge coordinate becomes a
  // tap outside the window and never wraps into it.
  const int ix = (int)fminf(fmaxf(xf, -2.f), (float)win_w);
  const int iy = (int)fminf(fmaxf(yf, -2.f), (float)win_h);
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int r = iy + dy;
    const float wy = dy ? fy : 1.f - fy;
    float left, step;  // the row's profile is left + fx * step
    if (kVariant & kNoLoad) {
      left = fx + (float)r;
      step = fy - (float)ix;
    } else if (kVariant == kStaged) {
      const bool rok = r >= 0 && r < win_h;
      const float* row = win + r * win_w;
      left = (rok && ix >= 0 && ix < win_w) ? row[ix] : 0.f;
      const float right = (rok && ix + 1 >= 0 && ix + 1 < win_w)
                              ? row[ix + 1] : 0.f;
      step = right - left;
    } else if (kGrad) {
      left = tap(img, width, w, r, ix);
      step = tap(grad, width, w, r, ix);
    } else {
      left = tap(img, width, w, r, ix);
      step = tap(img, width, w, r, ix + 1) - left;
    }
    acc += wy * (left + fx * step);
  }
  return acc;
}

}  // namespace window
