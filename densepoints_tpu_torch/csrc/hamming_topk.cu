// Ranked Hamming matching of view pairs for Hopper (sm_90a): M1.
//
// It replaces no Pallas kernel. The JAX package matches +-1 BRIEF
// descriptors with a `dot_general` in bf16 and `lax.top_k`
// (densepoints_tpu/features/matching.py:36-52), which XLA runs as a
// matrix product and a sort; the port ran the same chain in torch (an f32
// GEMM, seven N x M elementwise passes, a radix top-k). This kernel
// computes its contract (features/matching.py `_ranked_hamming`) for every
// pair of views in one launch: for query i of view a[p] and candidate j of
// view b[p], dist = (D - a.b) / 2; the key dist * M + j ranks the
// candidates, an invalid candidate at dist D + 1, after every valid one;
// the k smallest keys (k = 1 or 2), in order, leave the kernel as
// (idx (P, N, k) int64, dist (P, N, k) f32, 1e9 for an invalid partner).
// Keys are unique, so any merge order gives the same answer, and the
// answer is bitwise the plain version's.
//
// What bounds it on the H100: the int8 products, 2 N M D operations a pair
// (1,979 TOPS dense), and the epilogue's integer operations, about five an
// entry of the N x M matrix (an IMAD that forms the key, three min / max
// that keep the two smallest). Descriptors are read from device memory
// once a block (a query tile sliced as below, once a candidate tile) and
// stay in L2 across the blocks of a pair; the N x M matrix never touches
// device memory. The design:
//
//   - Exact int8 products: +-1 descriptors as int8 through
//     `mma.sync.m16n8k32.s8.s8.s32`; the int32 sums of +-1 are exact for
//     any D. A row of D bytes is zero-padded to a multiple of 32 in shared
//     memory (zeros add nothing to a dot; the key keeps the real D).
//   - One launch for all pairs: block x is one tile of kBM queries of one
//     pair; it loads a[p], b[p] and indexes the view stacks itself.
//   - Streamed candidates: view b[p]'s candidates stream through a
//     double-buffered ring of kBN rows, loaded with cp.async (an invalid
//     or absent candidate as zeros). Rows of up to kSlice bytes (the
//     seed stage's 256 bits) are one step each, and the query tile sits
//     in shared memory throughout. Wider rows go in slices of kSlice
//     bytes, the query tile's slice beside the candidates' in the ring,
//     and the slices' products add up in the same accumulators, so shared
//     memory does not grow with D. Rows are padded by 16 bytes, so the
//     eight rows an ldmatrix reads fall on distinct banks.
//   - Top-k in registers: 8 warps, 4 over the rows and 2 over the columns
//     of a tile, each a 32 x 64 tile of accumulators (64 int32 a thread).
//     The epilogue turns each sum s into 2 x key = C_j - s M, with C_j =
//     D M + 2 j (+ (D + 2) M for an invalid candidate, 2^32 - 1 past M)
//     computed once a tile, and keeps each of a thread's 4 rows' k smallest
//     keys in registers; after the last tile the 4 threads of a quad merge
//     by shuffles and the two column warps through shared memory.
//
// Keys fit in 32 bits: the wrapper refuses (D + 2) M >= 2^31, so 2 x key
// stays below 2^32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // queries a block
constexpr int kBN = 128;  // candidates a tile
constexpr int kSlice = 256;  // bytes of a row a step takes, at most
constexpr int kWarps = 8;  // 4 row warps x 2 column warps
constexpr int kThreads = 32 * kWarps;
constexpr int kLoadersPerRow = kThreads / kBN;  // threads that load a row
constexpr int kPad = 16;  // bytes after each shared row
constexpr unsigned kNone = 0xffffffffu;  // key of a column past M
constexpr float kBig = 1e9f;
static_assert(kBM == kBN, "a loader thread loads a query and a candidate row");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Merge a sorted partial list (p1, p2) into (b1, b2); K = 1 keeps b1 only.
template <int K>
__device__ __forceinline__ void merge(unsigned& b1, unsigned& b2, unsigned p1,
                                      unsigned p2) {
  if (K == 1) {
    b1 = min(b1, p1);
  } else {
    const unsigned hi = max(b1, p1);
    b1 = min(b1, p1);
    b2 = min(hi, min(b2, p2));
  }
}

// One new key into a row's list.
template <int K>
__device__ __forceinline__ void push(unsigned& b1, unsigned& b2,
                                     unsigned key) {
  if (K == 1) {
    b1 = min(b1, key);
  } else {
    const unsigned hi = max(b1, key);
    b1 = min(b1, key);
    b2 = min(b2, hi);
  }
}

struct Args {
  const int8_t* __restrict__ q;  // (VQ, N, row) queries
  const int8_t* __restrict__ c;  // (VC, M, row) candidates
  const uint8_t* __restrict__ valid;  // (VC, M) candidates' flags
  const int64_t* __restrict__ a;  // (P,) query view of each pair
  const int64_t* __restrict__ b;  // (P,) candidate view of each pair
  int64_t* __restrict__ idx;  // (P, N, K)
  float* __restrict__ dist;  // (P, N, K)
  int64_t VQ, VC;
  int N, M;
  int D;  // descriptor bits, the key's D
  int row;  // bytes a row in device memory: D rounded up to 16
  int Dp;  // bytes of a row the products take: D rounded up to 32
  int slices;  // steps a candidate tile: Dp over kSlice, rounded up
};

// kSliced: rows wider than kSlice bytes, taken a slice a step; the query
// tile's slices then stream beside the candidates'.
template <int K, bool kSliced>
__global__ void __launch_bounds__(kThreads, 2)
    hamming_topk_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQBufs = kSliced ? 2 : 1;
  const int S = (kSliced ? kSlice : args.Dp) + kPad;  // shared row stride
  unsigned char* qs = smem;  // [kQBufs][kBM][S]
  unsigned char* cs = qs + kQBufs * kBM * S;  // [2][kBN][S]
  unsigned* ck = reinterpret_cast<unsigned*>(cs + 2 * kBN * S);  // [2][kBN]
  unsigned* red = ck + 2 * kBN;  // [kBM][2]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int blocks_per_pair = (args.N + kBM - 1) / kBM;
  const int64_t p = blockIdx.x / blocks_per_pair;
  const int i0 = (int)(blockIdx.x % blocks_per_pair) * kBM;
  const int64_t va = args.a[p], vb = args.b[p];
  if (va < 0 || va >= args.VQ || vb < 0 || vb >= args.VC) __trap();
  const int N = args.N, M = args.M;
  const int slices = kSliced ? args.slices : 1;
  const int in_row = args.row / 16;  // 16-byte chunks a row in device memory
  const int8_t* qv = args.q + va * (int64_t)N * args.row;
  const int8_t* cv = args.c + vb * (int64_t)M * args.row;
  const uint8_t* valid = args.valid + vb * (int64_t)M;

  // Bytes of slice sl: a multiple of 32.
  auto width = [&](int sl) {
    return kSliced ? min(kSlice, args.Dp - sl * kSlice) : args.Dp;
  };
  // Each row of a tile is loaded by kLoadersPerRow threads, in alternating
  // 16-byte chunks; the first of them also writes the column's C_j. Chunks
  // past the row in device memory are zeros.
  const int ld_row = tid / kLoadersPerRow, ld_part = tid % kLoadersPerRow;
  const int i_ld = i0 + ld_row;
  auto load_rows = [&](unsigned char* dst, const int8_t* view, int r,
                       bool on_row, int sl) {
    const int c0 = sl * (kSlice / 16), chunks = width(sl) / 16;
    for (int ch = ld_part; ch < chunks; ch += kLoadersPerRow) {
      const bool on = on_row && c0 + ch < in_row;
      cp_async16(dst + ch * 16,
                 on ? view + (int64_t)r * args.row + (c0 + ch) * 16 : view,
                 on ? 16 : 0);
    }
  };
  if (!kSliced) load_rows(qs + ld_row * S, qv, i_ld, i_ld < N, 0);
  const unsigned DM = (unsigned)args.D * (unsigned)M;
  const unsigned invalid_add = (unsigned)(args.D + 2) * (unsigned)M;
  const int tiles = (M + kBN - 1) / kBN;
  const int steps = tiles * slices;
  // Step s takes slice s % slices of candidate tile s / slices.
  auto load_step = [&](int step, int buf, bool ok) {
    const int tile = step / slices, sl = step - tile * slices;
    const int j = tile * kBN + ld_row;
    load_rows(cs + (buf * kBN + ld_row) * S, cv, j, ok, sl);
    if (kSliced)
      load_rows(qs + (buf * kBM + ld_row) * S, qv, i_ld, i_ld < N, sl);
    if (ld_part == 0) {
      ck[buf * kBN + ld_row] =
          j >= M ? kNone
                 : DM + 2u * (unsigned)j + (ok ? 0u : invalid_add);
    }
  };
  auto flag = [&](int step) {
    const int j = step / slices * kBN + ld_row;
    return step < steps && j < M && valid[j] != 0;
  };
  load_step(0, 0, flag(0));
  cp_async_commit();
  bool next_ok = flag(1);

  unsigned b1[2][2], b2[2][2];  // [m tile][row half]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) b1[m][h] = b2[m][h] = kNone;

  const unsigned neg_m = 0u - (unsigned)M;
  // ldmatrix row addresses: A rows lane % 16 at byte (lane / 16) * 16 of a
  // 32-byte step; B rows (lane % 8) + (lane / 16) * 8 at (lane / 8 % 2) * 16.
  const unsigned qs_lane = smem_addr(qs) + (wr * 32 + (lane & 15)) * S +
                           (lane >> 4) * 16;
  const int b_lane_row = wc * 64 + (lane & 7) + (lane >> 4) * 8;
  const int b_lane_byte = ((lane >> 3) & 1) * 16;

  int acc[2][8][4];
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const int sl = kSliced ? step % slices : 0;
    if (step + 1 < steps) {
      load_step(step + 1, buf ^ 1, next_ok);
      cp_async_commit();
      next_ok = flag(step + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (sl == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;
    }

    const unsigned qs_step = qs_lane + (kSliced ? buf * kBM * S : 0);
    const unsigned cs_lane =
        smem_addr(cs) + (buf * kBN + b_lane_row) * S + b_lane_byte;
    const int kend = width(sl);
    for (int kk = 0; kk < kend; kk += 32) {
      unsigned af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4(qs_step + m * 16 * S + kk, af[m][0], af[m][1], af[m][2],
                    af[m][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r0, r1, r2, r3;
        ldmatrix_x4(cs_lane + np * 16 * S + kk, r0, r1, r2, r3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_s8(acc[m][2 * np], af[m], r0, r1);
          mma_s8(acc[m][2 * np + 1], af[m], r2, r3);
        }
      }
    }

    // Epilogue, after a tile's last slice: 2 x key = C_j - s M for the
    // thread's columns 2t, 2t + 1 of each n tile, rows g (acc 0, 1) and
    // g + 8 (acc 2, 3) of each m tile.
    if (sl == slices - 1) {
      const unsigned* ckb = ck + buf * kBN + wc * 64 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint2 cc = *reinterpret_cast<const uint2*>(ckb + n * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            push<K>(b1[m][h], b2[m][h],
                    (unsigned)acc[m][n][2 * h] * neg_m + cc.x);
            push<K>(b1[m][h], b2[m][h],
                    (unsigned)acc[m][n][2 * h + 1] * neg_m + cc.y);
          }
        }
      }
    }
    __syncthreads();  // the buffer is loaded again two steps on
  }

  // The quad's four column sets, then the two column warps.
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const unsigned p1 = __shfl_xor_sync(0xffffffffu, b1[m][h], off);
        const unsigned p2 = __shfl_xor_sync(0xffffffffu, b2[m][h], off);
        merge<K>(b1[m][h], b2[m][h], p1, p2);
      }
  if (wc == 1 && t == 0) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + m * 16 + h * 8 + g;
        red[2 * r] = b1[m][h];
        red[2 * r + 1] = b2[m][h];
      }
  }
  __syncthreads();
  if (wc == 1 || t != 0) return;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr * 32 + m * 16 + h * 8 + g;
      const int i = i0 + r;
      if (i >= N) continue;
      merge<K>(b1[m][h], b2[m][h], red[2 * r], red[2 * r + 1]);
      const unsigned keys[2] = {b1[m][h], b2[m][h]};
      const int64_t out = (p * N + i) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const unsigned key = keys[q] >> 1;
        const unsigned d = key / (unsigned)M;
        args.idx[out + q] = (int64_t)(key - d * (unsigned)M);
        args.dist[out + q] = d > (unsigned)args.D ? kBig : (float)d;
      }
    }
}

// Shared bytes of a block: the query tile (two slices of it in the ring
// for sliced rows), two candidate tiles, the columns' C_j and the merge
// lists.
int64_t smem_bytes(bool sliced, int64_t Dp) {
  const int64_t S = (sliced ? kSlice : Dp) + kPad;
  return ((sliced ? 2 : 1) * kBM + 2 * kBN) * S +
         (int64_t)(2 * kBN + 2 * kBM) * (int64_t)sizeof(unsigned);
}

template <int K, bool kSliced>
int launch(const Args& args, int64_t blocks, cudaStream_t stream) {
  const int64_t smem = smem_bytes(kSliced, args.Dp);
  const cudaError_t err = cudaFuncSetAttribute(
      hamming_topk_kernel<K, kSliced>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hamming_topk_kernel<K, kSliced>
      <<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hamming_topk_launch(const int8_t* q, const int8_t* c,
                                   const uint8_t* valid, const int64_t* a,
                                   const int64_t* b, int64_t* idx, float* dist,
                                   int64_t VQ, int64_t VC, int64_t P,
                                   int64_t N, int64_t M, int64_t D,
                                   int64_t row, int64_t k, void* stream) {
  const int64_t Dp = (D + 31) / 32 * 32;
  if (Dp > INT32_MAX - kSlice || N > INT32_MAX || M > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const bool sliced = Dp > kSlice;
  const Args args{q, c, valid, a, b, idx, dist, VQ, VC, (int)N, (int)M,
                  (int)D, (int)row, (int)Dp,
                  (int)((Dp + kSlice - 1) / kSlice)};
  const int64_t blocks = P * ((N + kBM - 1) / kBM);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    return sliced ? launch<1, true>(args, blocks, s)
                  : launch<1, false>(args, blocks, s);
  if (k == 2)
    return sliced ? launch<2, true>(args, blocks, s)
                  : launch<2, false>(args, blocks, s);
  return (int)cudaErrorInvalidValue;
}
