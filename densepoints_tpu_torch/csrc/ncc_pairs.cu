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
// operations per element. The design reads each row with one warp, lane i
// taking elements i, i + 32, ... so every load is a coalesced 128-byte line;
// the second pass re-reads the row's ~0.5-1 KB from L1; the five sums are
// reduced with warp shuffles, so nothing but the inputs and one f32 per row
// crosses device memory and no shared memory or block barrier is used.

#include "warp_ncc_common.cuh"

namespace {

using warp_ncc::warp_sum;

constexpr int kRowsPerBlock = 8;  // one warp per row

template <bool kMasked>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ncc_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ mask, int64_t N, int64_t L,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const float* ar = a + row * L;
  const float* br = b + row * L;
  const float* mr = kMasked ? mask + row * L : nullptr;

  float sa = 0.f, sb = 0.f, cnt = 0.f;
  for (int64_t i = lane; i < L; i += 32) {
    if (kMasked) {
      const float m = mr[i];
      sa += ar[i] * m;
      sb += br[i] * m;
      cnt += m;
    } else {
      sa += ar[i];
      sb += br[i];
    }
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  const float n = kMasked ? warp_sum(cnt) : (float)L;
  const float n_safe = kMasked ? fmaxf(n, 1.f) : n;
  const float am = sa / n_safe, bm = sb / n_safe;

  float cov = 0.f, va = 0.f, vb = 0.f;
  for (int64_t i = lane; i < L; i += 32) {
    float ca = ar[i] - am, cb = br[i] - bm;
    if (kMasked) {
      const float m = mr[i];
      ca *= m;
      cb *= m;
    }
    cov += ca * cb;
    va += ca * ca;
    vb += cb * cb;
  }
  cov = warp_sum(cov) / n_safe;
  va = warp_sum(va) / n_safe;
  vb = warp_sum(vb) / n_safe;
  if (lane == 0) {
    const float score = cov / fmaxf(sqrtf(va) * sqrtf(vb), 0.1f);
    out[row] = (kMasked && !(n > 0.f)) ? -1.f : score;
  }
}

}  // namespace

// `mask` may be null: the maskless variant (n = L).
extern "C" int ncc_pairs_launch(const float* a, const float* b,
                                const float* mask, int64_t N, int64_t L,
                                float* out, void* stream) {
  const unsigned int blocks =
      (unsigned int)((N + kRowsPerBlock - 1) / kRowsPerBlock);
  const int threads = kRowsPerBlock * 32;
  if (mask) {
    ncc_pairs_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        a, b, mask, N, L, out);
  } else {
    ncc_pairs_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        a, b, nullptr, N, L, out);
  }
  return (int)cudaGetLastError();
}
