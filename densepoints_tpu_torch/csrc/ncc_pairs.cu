// Row-wise NCC of (N, L) texture pairs for Hopper (sm_90a).
//
// Replaces the TPU kernels densepoints_tpu/ops/ncc.py `_ncc_kernel_nomask`
// and `_ncc_kernel` (launched by `ncc_pairs_pallas`, dispatched by
// `ncc_pairs`). out[i] = cov(a_i, b_i) / max(sigma_a * sigma_b, 0.1) with
// population statistics in two passes (mean, then centred sums). With a mask,
// n = sum(mask_i), the means divide by max(n, 1), the centred values are
// multiplied by the mask, and a row whose mask is empty gets -1.
//
// Not carried over from the TPU kernel: the 1024-row tiles and the padding of
// the row count to them.
//
// What bounds it on the H100: bytes. Each input element is needed once
// (2 or 3 x N x L x 4 bytes in, N x 4 out) and there are about ten f32
// operations per element. But a row of L = 121 is only 1 KB, and what a row
// costs besides its loads (five group sums, three divisions, two square
// roots and a store) is paid per row: with a warp per row that chain alone,
// timed with the loads taken out, took three quarters of the whole kernel's
// time, so a row gets as few lanes as hold it in 8 registers per array.
//
// Group body (L <= 256, the rows of every caller): a group of G = 8, 16 or
// 32 lanes (the fewest with G >= L / 8) takes a row, 32 / G rows per warp;
// lane g holds elements g, g + G, ... of it, C = ceil(L / G) <= 8 per array.
// A lane issues all of its 2C (3C masked) loads of a row into registers
// before the first add, the tail predicated by i < L; the means come from
// shuffles within the group, and the centred sums from the same registers,
// so no element is read twice. The grid is one wave of resident blocks, and
// each warp walks its rows `stride` apart, issuing the loads of its next rows
// before it reduces the current ones. No shared memory, no block barrier.
//
// Strided body (L > 256): one warp per row in blocks of 8 rows, lane i
// looping over i, i + 32, ..., then a second loop over the row for the
// centred sums (its ~1 KB mostly from L1).

#include "warp_ncc_common.cuh"

namespace {

using warp_ncc::kFullMask;

constexpr int kWarps = 8;  // warps of a block of either body
constexpr int kMaxChunks = 8;  // elements per lane and array of a group row

// Sum over the G lanes of a group (G a power of two, groups aligned).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// A lane's elements of one row: chunk j is element g + G j.
template <int C, bool kMasked>
struct Row {
  float a[C], b[C], m[kMasked ? C : 1];
};

// Row `row` (`live`: row < N) into `r`; a lane of a dead row holds zeros.
template <int G, int C, bool kMasked>
__device__ __forceinline__ void load_row(Row<C, kMasked>& r,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const float* __restrict__ mask,
                                         int64_t row, bool live, int L,
                                         int g) {
  const int64_t base = row * L;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int i = g + G * j;
    const bool in = live && (j < C - 1 || i < L);  // only chunk C-1 is ragged
    r.a[j] = in ? a[base + i] : 0.f;
    r.b[j] = in ? b[base + i] : 0.f;
    if (kMasked) r.m[j] = in ? mask[base + i] : 0.f;
  }
}

template <int G, int C, bool kMasked>
__device__ __forceinline__ float score_row(const Row<C, kMasked>& r, int L,
                                           int g) {
  float sa = 0.f, sb = 0.f, cnt = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (kMasked) {
      sa += r.a[j] * r.m[j];
      sb += r.b[j] * r.m[j];
      cnt += r.m[j];
    } else {
      sa += r.a[j];
      sb += r.b[j];
    }
  }
  sa = group_sum<G>(sa);
  sb = group_sum<G>(sb);
  const float n = kMasked ? group_sum<G>(cnt) : (float)L;
  const float n_safe = kMasked ? fmaxf(n, 1.f) : n;
  const float am = sa / n_safe, bm = sb / n_safe;

  float cov = 0.f, va = 0.f, vb = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float ca = r.a[j] - am, cb = r.b[j] - bm;
    if (kMasked) {  // the tail's mask is 0
      ca *= r.m[j];
      cb *= r.m[j];
    } else if (j == C - 1 && g + G * j >= L) {
      ca = cb = 0.f;
    }
    cov += ca * cb;
    va += ca * ca;
    vb += cb * cb;
  }
  cov = group_sum<G>(cov) / n_safe;
  va = group_sum<G>(va) / n_safe;
  vb = group_sum<G>(vb) / n_safe;
  const float score = cov / fmaxf(sqrtf(va) * sqrtf(vb), 0.1f);
  return (kMasked && !(n > 0.f)) ? -1.f : score;
}

// At least 3 blocks per SM (80 registers at most): without that hint
// ptxas traded a spill for a fourth block in one instance.
template <int G, int C, bool kMasked>
__global__ void __launch_bounds__(kWarps * 32, 3)
    ncc_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ mask, int64_t N, int L,
                    float* __restrict__ out) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31, g = lane % G, mine = lane / G;
  const int64_t stride = (int64_t)gridDim.x * kWarps * kRowsPerWarp;
  // The first of this warp's rows in the current step; the lane's is
  // first + mine.
  int64_t first =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRowsPerWarp;
  if (first >= N) return;  // whole warps leave together
  // Reduce `cur` (rows from `first`) after loading `ahead` (the next step's
  // rows); false when there is no next step.
  auto step = [&](const Row<C, kMasked>& cur, Row<C, kMasked>& ahead,
                  int64_t at) {
    const int64_t next = at + stride;
    if (next < N)
      load_row<G, C, kMasked>(ahead, a, b, mask, next + mine, next + mine < N,
                              L, g);
    const float s = score_row<G, C, kMasked>(cur, L, g);
    if (g == 0 && at + mine < N) out[at + mine] = s;
    return next < N;
  };
  Row<C, kMasked> r0, r1;  // ping-pong: no copy between steps
  load_row<G, C, kMasked>(r0, a, b, mask, first + mine, first + mine < N, L,
                          g);
  while (step(r0, r1, first) && step(r1, r0, first + stride))
    first += 2 * stride;
}

template <bool kMasked>
__global__ void __launch_bounds__(kWarps * 32)
    ncc_strided_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ mask, int64_t N, int64_t L,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const float* ar = a + row * L;
  const float* br = b + row * L;
  const float* mr = kMasked ? mask + row * L : nullptr;

  float sa = 0.f, sb = 0.f, cnt = 0.f;
  for (int64_t i = lane; i < L; i += 32) {
    if (kMasked) {
      sa += ar[i] * mr[i];
      sb += br[i] * mr[i];
      cnt += mr[i];
    } else {
      sa += ar[i];
      sb += br[i];
    }
  }
  sa = group_sum<32>(sa);
  sb = group_sum<32>(sb);
  const float n = kMasked ? group_sum<32>(cnt) : (float)L;
  const float n_safe = kMasked ? fmaxf(n, 1.f) : n;
  const float am = sa / n_safe, bm = sb / n_safe;

  float cov = 0.f, va = 0.f, vb = 0.f;
  for (int64_t i = lane; i < L; i += 32) {
    float ca = ar[i] - am, cb = br[i] - bm;
    if (kMasked) {
      ca *= mr[i];
      cb *= mr[i];
    }
    cov += ca * cb;
    va += ca * ca;
    vb += cb * cb;
  }
  cov = group_sum<32>(cov) / n_safe;
  va = group_sum<32>(va) / n_safe;
  vb = group_sum<32>(vb) / n_safe;
  if (lane == 0) {
    const float score = cov / fmaxf(sqrtf(va) * sqrtf(vb), 0.1f);
    out[row] = (kMasked && !(n > 0.f)) ? -1.f : score;
  }
}

template <int G, int C, bool kMasked>
cudaError_t launch_rows(const float* a, const float* b, const float* mask,
                        int64_t N, int L, float* out, cudaStream_t stream) {
  // One wave: as many blocks as the card holds at once, no more than the
  // rows need. The occupancy of an instance is fixed: asked once.
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ncc_rows_kernel<G, C, kMasked>, kWarps * 32, 0);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = kWarps * (32 / G);
  const int64_t wanted = (N + rows_per_block - 1) / rows_per_block;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks = (unsigned int)(wanted < wave ? wanted : wave);
  ncc_rows_kernel<G, C, kMasked><<<blocks, kWarps * 32, 0, stream>>>(
      a, b, mask, N, L, out);
  return cudaGetLastError();
}

// Group rows of L <= 256: G lanes a row, the fewest with C = ceil(L / G)
// <= 8, but no fewer than 8 (a group's load is then at least one 32-byte
// sector).
template <bool kMasked>
cudaError_t launch_groups(const float* a, const float* b, const float* mask,
                          int64_t N, int L, float* out, cudaStream_t stream) {
#define NCC_ROWS(G, C) \
  launch_rows<G, C, kMasked>(a, b, mask, N, L, out, stream)
  if (L > 128) {
    switch ((L + 31) / 32) {
      case 5: return NCC_ROWS(32, 5);
      case 6: return NCC_ROWS(32, 6);
      case 7: return NCC_ROWS(32, 7);
      default: return NCC_ROWS(32, 8);
    }
  }
  if (L > 64) {
    switch ((L + 15) / 16) {
      case 5: return NCC_ROWS(16, 5);
      case 6: return NCC_ROWS(16, 6);
      case 7: return NCC_ROWS(16, 7);
      default: return NCC_ROWS(16, 8);
    }
  }
  switch ((L + 7) / 8) {
    case 1: return NCC_ROWS(8, 1);
    case 2: return NCC_ROWS(8, 2);
    case 3: return NCC_ROWS(8, 3);
    case 4: return NCC_ROWS(8, 4);
    case 5: return NCC_ROWS(8, 5);
    case 6: return NCC_ROWS(8, 6);
    case 7: return NCC_ROWS(8, 7);
    default: return NCC_ROWS(8, 8);
  }
#undef NCC_ROWS
}

template <bool kMasked>
cudaError_t launch_masked(const float* a, const float* b, const float* mask,
                          int64_t N, int64_t L, float* out,
                          cudaStream_t stream) {
  if (L > 32 * kMaxChunks) {
    const unsigned int blocks = (unsigned int)((N + kWarps - 1) / kWarps);
    ncc_strided_kernel<kMasked><<<blocks, kWarps * 32, 0, stream>>>(
        a, b, mask, N, L, out);
    return cudaGetLastError();
  }
  return launch_groups<kMasked>(a, b, mask, N, (int)L, out, stream);
}

}  // namespace

// `mask` may be null: the maskless variant (n = L).
extern "C" int ncc_pairs_launch(const float* a, const float* b,
                                const float* mask, int64_t N, int64_t L,
                                float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(mask ? launch_masked<true>(a, b, mask, N, L, out, s)
                    : launch_masked<false>(a, b, nullptr, N, L, out, s));
}
