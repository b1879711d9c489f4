// One Nelder-Mead step of the photometric objective for Hopper (sm_90a): three
// kernels around two launches of the all-views kernel (allview_ncc.cu, K1).
//
// The JAX package has no Pallas kernel for this work. Its solver is one XLA
// program per slice (densepoints_tpu/pmvs/optimize.py `_optimize_patches_jit`)
// whose `lax.while_loop` runs `nelder_mead`'s body
// (densepoints_tpu/ops/simplex.py:53-104) with the objective of
// `photometric_objective_paged` (densepoints_tpu/pmvs/optimize.py:315-338)
// inside it, and XLA fuses the body's elementwise work into a few kernels
// around the two Pallas scoring calls. These three kernels are that fusion:
//
//   nm_reflect   stable sort of each lane's 4 vertices by f-value, the
//                centroid of the best three, the reflection x_r, and its pose
//                (`unparametrize`) written into K1's position / normal;
//   (K1 scores x_r: a (B, V) grid)
//   nm_contract  f_r, the mean of 1 - score over the payload views (2 where
//                a lane has none), the second candidate x_2 (expansion,
//                outside or inside contraction) and its pose into K1's inputs;
//   (K1 scores x_2)
//   nm_accept    f_2 likewise, the accept rules, the new worst vertex of
//                every active lane, the spread test, `done`, `iters`, the
//                step count and the exit flag (every lane done, or the cap).
//
// Each runs one thread per lane (D = 3 parameters, 4 vertices) on buffers
// that live for one solver call, so a CUDA graph captures the five launches
// of a step with fixed addresses. The arithmetic is the torch step's
// (ops/simplex.py `_step`, ops/nm_step.py's plain twins) with the same
// roundings where an op rounds once (`__f*_rn`: no contraction into fused
// multiply-adds) and the precise `cosf` / `sinf`; the sums over the payload
// views and the 3 x 3 rotation run in another order than torch's, so the
// values agree within f32 rounding, not bitwise.
//
// What bounds it on the H100: neither bytes nor operations. A lane moves
// about 100 bytes of state and 5 V bytes of grid and mask, and does a few
// hundred operations; at the batch sizes of the path (one to a few thousand
// lanes, up to 16,384) a kernel is a few microseconds of work, below the
// launch latency. The design therefore does the least that is right: no
// shared memory, one pass, registers only; the exit flag is the one
// cross-lane result, and the last block to finish writes it (a count of
// blocks with a live lane and a ticket counter, both reset by that block).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVerts = 4;  // D + 1 vertices of D = 3 parameters
constexpr float kAlpha = 1.0f;  // reflection
constexpr float kGamma = 2.0f;  // expansion
constexpr float kRho = 0.5f;  // contraction

// The pose a lane's parameters start from: position0, normal0 and the
// reference camera's centre, each (B, 3).
struct Pose {
  const float* __restrict__ position0;
  const float* __restrict__ normal0;
  const float* __restrict__ C_ref;
};

// `unparametrize` of pmvs/optimize.py for lane b's parameters x (depth,
// roll, pitch): position = C + (1 + depth)(position0 - C), rounded as torch
// rounds its four elementwise ops; normal = R(roll, pitch) normal0.
__device__ __forceinline__ void pose(const Pose& p, int64_t b, const float x[3],
                                     float* __restrict__ position,
                                     float* __restrict__ normal) {
  const float scale = __fadd_rn(1.0f, x[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float c = p.C_ref[b * 3 + i];
    position[b * 3 + i] = __fadd_rn(
        c, __fmul_rn(scale, __fsub_rn(p.position0[b * 3 + i], c)));
  }
  const float ca = cosf(x[1]), sa = sinf(x[1]);
  const float cb = cosf(x[2]), sb = sinf(x[2]);
  const float R[3][3] = {
      {cb, 0.0f, -sb},
      {__fmul_rn(sa, sb), ca, __fmul_rn(cb, sa)},
      {__fmul_rn(ca, sb), -sa, __fmul_rn(ca, cb)},
  };
  const float n0 = p.normal0[b * 3], n1 = p.normal0[b * 3 + 1],
              n2 = p.normal0[b * 3 + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    normal[b * 3 + i] = R[i][0] * n0 + R[i][1] * n1 + R[i][2] * n2;
}

// The objective of lane b from its row of K1's grid: the mean of 1 - score
// over the payload views (visible, not the anchor), 2 where there is none.
// The count is an int64 that torch promotes to f32 before it divides.
__device__ __forceinline__ float cost(const float* __restrict__ scores,
                                      const uint8_t* __restrict__ payload,
                                      const int64_t* __restrict__ n_payload,
                                      int64_t b, int64_t V) {
  const int64_t n = n_payload[b];
  if (n <= 0) return 2.0f;
  float err = 0.0f;
  for (int64_t v = 0; v < V; ++v)
    if (payload[b * V + v]) err = __fadd_rn(err, __fsub_rn(1.0f, scores[b * V + v]));
  return __fdiv_rn(err, (float)n);
}

// Whether (fa, ia) sorts after (fb, ib): ascending f-values, NaN last, ties
// (and two NaNs) in index order. A total order, so any sorting network gives
// `torch.argsort(stable=True)`'s permutation.
__device__ __forceinline__ bool after(float fa, int ia, float fb, int ib) {
  const bool na = isnan(fa), nb = isnan(fb);
  if (na != nb) return na;
  if (!na && fa != fb) return fa > fb;
  return ia > ib;
}

__device__ __forceinline__ void exchange(float f[kVerts], int idx[kVerts],
                                         float v[kVerts][3], int i, int j) {
  if (!after(f[i], idx[i], f[j], idx[j])) return;
  const float tf = f[i]; f[i] = f[j]; f[j] = tf;
  const int ti = idx[i]; idx[i] = idx[j]; idx[j] = ti;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float t = v[i][d]; v[i][d] = v[j][d]; v[j][d] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    nm_reflect_kernel(Pose p, float* __restrict__ verts,
                      float* __restrict__ fvals, float* __restrict__ centroid,
                      float* __restrict__ x_r, float* __restrict__ position,
                      float* __restrict__ normal, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float f[kVerts], v[kVerts][3];
  int idx[kVerts];
#pragma unroll
  for (int k = 0; k < kVerts; ++k) {
    f[k] = fvals[b * kVerts + k];
    idx[k] = k;
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = verts[(b * kVerts + k) * 3 + d];
  }
  // A sorting network of 4 (5 compare-exchanges) on the total order above.
  exchange(f, idx, v, 0, 1);
  exchange(f, idx, v, 2, 3);
  exchange(f, idx, v, 0, 2);
  exchange(f, idx, v, 1, 3);
  exchange(f, idx, v, 1, 2);
  float xr[3];
#pragma unroll
  for (int k = 0; k < kVerts; ++k) {
    fvals[b * kVerts + k] = f[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) verts[(b * kVerts + k) * 3 + d] = v[k][d];
  }
  // The centroid as torch's CUDA mean takes it: the sum times 1/3 in f32
  // (an ulp of x_r at a large angle moves cos and sin by as much).
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = __fmul_rn(__fadd_rn(__fadd_rn(v[0][d], v[1][d]), v[2][d]),
                              1.0f / 3.0f);
    centroid[b * 3 + d] = c;
    xr[d] = __fadd_rn(c, __fmul_rn(kAlpha, __fsub_rn(c, v[3][d])));
    x_r[b * 3 + d] = xr[d];
  }
  pose(p, b, xr, position, normal);
}

__global__ void __launch_bounds__(kThreads)
    nm_contract_kernel(Pose p, const float* __restrict__ scores,
                       const uint8_t* __restrict__ payload,
                       const int64_t* __restrict__ n_payload, int64_t V,
                       const float* __restrict__ verts,
                       const float* __restrict__ fvals,
                       const float* __restrict__ centroid,
                       const float* __restrict__ x_r, float* __restrict__ f_r,
                       float* __restrict__ x_2, float* __restrict__ position,
                       float* __restrict__ normal, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float fr = cost(scores, payload, n_payload, b, V);
  f_r[b] = fr;
  const bool expand = fr < fvals[b * kVerts];
  const bool outside = fr < fvals[b * kVerts + kVerts - 1];
  float x2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = centroid[b * 3 + d];
    const float worst = verts[(b * kVerts + kVerts - 1) * 3 + d];
    x2[d] = expand ? __fadd_rn(c, __fmul_rn(kGamma, __fsub_rn(c, worst)))
          : outside
              ? __fadd_rn(c, __fmul_rn(kRho, __fsub_rn(x_r[b * 3 + d], c)))
              : __fsub_rn(c, __fmul_rn(kRho, __fsub_rn(c, worst)));
    x_2[b * 3 + d] = x2[d];
  }
  pose(p, b, x2, position, normal);
}

__global__ void __launch_bounds__(kThreads)
    nm_accept_kernel(const float* __restrict__ scores,
                     const uint8_t* __restrict__ payload,
                     const int64_t* __restrict__ n_payload, int64_t V,
                     float* __restrict__ verts, float* __restrict__ fvals,
                     uint8_t* __restrict__ done, int* __restrict__ iters,
                     int64_t* step, const float* __restrict__ x_r,
                     const float* __restrict__ f_r,
                     const float* __restrict__ x_2, int64_t max_iterations,
                     float tolerance, uint8_t* __restrict__ flag,
                     int* counters, int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t s = *step;
  bool live = false;
  if (b < B) {
    const float f2 = cost(scores, payload, n_payload, b, V);
    const float fr = f_r[b];
    float f[kVerts];
#pragma unroll
    for (int k = 0; k < kVerts; ++k) f[k] = fvals[b * kVerts + k];
    // Accept rules (no shrink; contraction always replaces the worst).
    const bool expand = fr < f[0];
    const bool use2 = expand ? f2 < fr : (fr >= f[kVerts - 2]) && (f2 < fr);
    const float f_new = use2 ? f2 : fr;
    const bool improved = f_new < f[kVerts - 1];
    const bool active = !done[b] && s < max_iterations;
    if (active && improved) {
      f[kVerts - 1] = f_new;
      fvals[b * kVerts + kVerts - 1] = f_new;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        verts[(b * kVerts + kVerts - 1) * 3 + d] =
            use2 ? x_2[b * 3 + d] : x_r[b * 3 + d];
    }
    // The spread of the f-values; a NaN among them (torch's max and min
    // propagate it) fails the test.
    bool nan = false;
    float hi = f[0], lo = f[0];
#pragma unroll
    for (int k = 0; k < kVerts; ++k) {
      nan |= isnan(f[k]);
      hi = fmaxf(hi, f[k]);
      lo = fminf(lo, f[k]);
    }
    const bool now_done = done[b] || (!nan && __fsub_rn(hi, lo) < tolerance);
    done[b] = now_done;
    iters[b] += active;
    live = !now_done && s + 1 < max_iterations;
  }
  // The exit flag: no lane live at the next step. Each block that has a live
  // lane counts itself; the last block to take a ticket has seen every
  // block's count (and every block has read the step), so it writes the
  // flag and the next step and resets both counters for the next launch.
  if (__syncthreads_or(live) && threadIdx.x == 0) atomicAdd(&counters[0], 1);
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&counters[1], 1) == (int)gridDim.x - 1) {
      *flag = atomicExch(&counters[0], 0) == 0;
      counters[1] = 0;
      *step = s + 1;
    }
  }
}

unsigned int blocks(int64_t B) {
  return (unsigned int)((B + kThreads - 1) / kThreads);
}

}  // namespace

// Each launcher returns cudaGetLastError() (a refused launch, e.g. of an
// empty grid, is reported and nothing runs).

extern "C" int nm_reflect_launch(const float* position0, const float* normal0,
                                 const float* C_ref, float* verts,
                                 float* fvals, float* centroid, float* x_r,
                                 float* position, float* normal, int64_t B,
                                 void* stream) {
  nm_reflect_kernel<<<blocks(B), kThreads, 0, (cudaStream_t)stream>>>(
      Pose{position0, normal0, C_ref}, verts, fvals, centroid, x_r, position,
      normal, B);
  return (int)cudaGetLastError();
}

extern "C" int nm_contract_launch(
    const float* position0, const float* normal0, const float* C_ref,
    const float* scores, const uint8_t* payload, const int64_t* n_payload,
    int64_t V, const float* verts, const float* fvals, const float* centroid,
    const float* x_r, float* f_r, float* x_2, float* position, float* normal,
    int64_t B, void* stream) {
  nm_contract_kernel<<<blocks(B), kThreads, 0, (cudaStream_t)stream>>>(
      Pose{position0, normal0, C_ref}, scores, payload, n_payload, V, verts,
      fvals, centroid, x_r, f_r, x_2, position, normal, B);
  return (int)cudaGetLastError();
}

extern "C" int nm_accept_launch(
    const float* scores, const uint8_t* payload, const int64_t* n_payload,
    int64_t V, float* verts, float* fvals, uint8_t* done, int* iters,
    int64_t* step, const float* x_r, const float* f_r, const float* x_2,
    int64_t max_iterations, float tolerance, uint8_t* flag, int* counters,
    int64_t B, void* stream) {
  nm_accept_kernel<<<blocks(B), kThreads, 0, (cudaStream_t)stream>>>(
      scores, payload, n_payload, V, verts, fvals, done, iters, step, x_r,
      f_r, x_2, max_iterations, tolerance, flag, counters, B);
  return (int)cudaGetLastError();
}
